from tracer_torch.scene.builder import (
    Material, Light, Sphere, Square, MeshObject, SceneBuilder,
    DIFFUSE, GLASS, MIRROR, TEX_NONE, TEX_CHECKERBOARD, TEX_IMAGE,
)
from tracer_torch.scene.device import (
    DeviceScene, compile_scene, device_scene_from_numpy)

__all__ = [
    "Material", "Light", "Sphere", "Square", "MeshObject", "SceneBuilder",
    "DeviceScene", "compile_scene", "device_scene_from_numpy",
    "DIFFUSE", "GLASS", "MIRROR", "TEX_NONE", "TEX_CHECKERBOARD", "TEX_IMAGE",
]
