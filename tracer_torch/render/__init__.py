from tracer_torch.render.camera import Camera, default_camera, generate_rays
from tracer_torch.render.renderer import render, render_image

__all__ = ["Camera", "default_camera", "generate_rays", "render",
           "render_image"]
