"""The viewer: a closed loop of `tracer_torch.render.renderer.render`, one
frame a call at the traffic's samples, each from the next pose of the
seeded camera path, the image on the host (`render` returns it
gamma-corrected as numpy). One frame's latency runs from the call to the
image on the host; the rate is every frame's rays over the window.

A run: the port and its kernels load, the scene is built from the
recipe and the seed, two frames warm up (the first captures the frame's
one-sample graph), then the window; with `--trace 1` a steady stretch of
frames inside it runs under the profiler. After the window the
program's state is freed and the check renders frames drawn from the
seed with the reference."""

from __future__ import annotations

import importlib
import time

import numpy as np

from portbench import camera_path, check, core, rooflines, trace

TRACED_FRAMES = 8     # frames under the profiler in a traced run
COUNT_PIXELS = 1 << 16   # the reference's live-lane count: pixels of one


class Plan:
    """What both sides of a render cell take from the cell and the seed:
    the frame's size, samples, seed word, scene recipe and camera path."""

    def __init__(self, cell: core.Cell, seed: int, size=None):
        c = cell.config
        self.cell, self.seed = cell, seed
        self.width, self.height = size or (c["width"], c["height"])
        self.spp = cell.traffic["spp"]
        self.word = seed % 2 ** 32
        self.recipe = importlib.import_module(f"portbench.scenes.{c['scene']}")
        self.poses = camera_path.poses(seed, 64, c, cell.traffic)

    def pose(self, i: int) -> np.ndarray:
        if i >= self.poses.shape[0]:
            self.poses = camera_path.poses(self.seed, 2 * i, self.cell.config,
                                           self.cell.traffic)
        return self.poses[i]


class Frames(Plan):
    """The program's side of a render cell: scene, config and cameras."""

    def __init__(self, cell: core.Cell, seed: int, spans: core.Spans,
                 device: str, size=None):
        import torch
        with spans("imports"):
            from tracer_torch.core.config import RenderConfig
            from tracer_torch.render import renderer
            from tracer_torch.scene import builder as TB
            from tracer_torch.scene.device import compile_scene

        super().__init__(cell, seed, size)
        self.device, self.render = device, renderer.render
        c = cell.config
        if device == "cuda":
            from tracer_torch.kernels import _build
            with spans("load_kernels"):
                _build.library()
        with spans("scene_build"):
            self.scene = compile_scene(self.recipe.build(TB, c, seed),
                                       leaf_width=c["bvh_leaf_size"],
                                       device=device)
            if device == "cuda":
                torch.cuda.synchronize()
        self.cfg = RenderConfig(nsamples=self.spp, width=self.width,
                                height=self.height,
                                max_bounces=c["max_bounces"],
                                shadow_rays=c["shadow_rays"],
                                compat=c["compat"], seed=self.word)

    def camera(self, i: int):
        import torch
        from tracer_torch.render.camera import Camera
        p = self.pose(i)
        f = dict(dtype=torch.float32, device=self.device)
        return Camera(torch.tensor(p[:3], **f), torch.tensor(p[3:], **f),
                      torch.tensor(self.cell.config["camera"]["fov_deg"], **f),
                      torch.tensor(self.width / self.height, **f))

    def frame(self, i: int) -> np.ndarray:
        return self.render(self.scene, self.camera(i), self.cfg)

    def release(self):
        self.scene = self.cfg = None


def window(frames, seconds: float, spans: core.Spans, pix: np.ndarray,
           traced: bool, first: int = 2):
    """The measured loop from pose `first`: (latencies, kept pixels a
    frame, window seconds, trace or None)."""
    lat, kept = [], []
    tr = None
    i = first

    def one():
        nonlocal i
        t0 = time.perf_counter()
        with spans("frame"):
            img = frames.frame(i)
        lat.append(time.perf_counter() - t0)
        kept.append(img.reshape(-1, 3)[pix].copy())
        i += 1

    start = time.perf_counter()
    if traced:
        for _ in range(2):          # into the steady state first
            one()
        tr = trace.record(lambda: [one() for _ in range(TRACED_FRAMES)],
                          spans, "frames")
    while True:
        one()
        if time.perf_counter() - start >= seconds:
            break
    return lat, kept, time.perf_counter() - start, tr


def scene_dims(rs) -> dict:
    """The scene's sizes the roofline counts take, from the reference's
    own scene."""
    return dict(
        spheres=rs.n_sph_real, quads=rs.n_quad_real,
        spheres_padded=rs.sph_center.shape[0],
        quads_padded=rs.quad_v0.shape[0],
        materials=rs.mat_diffuse.shape[0], meshes=len(rs.mesh_root),
        nodes=rs.bvh_lo.shape[0], triangles=rs.tri_a.shape[0] - 1,
        leaf_width=rs.leaf_width, lights=rs.light_pos.shape[0],
        atlas=bool(rs.tex_data.shape[0] > 1 or rs.nm_data.shape[0] > 1),
        texels=rs.tex_data.shape[0],
        textured=bool((rs.mat_textype != 0).any()),
        emissive_tex_image=bool(rs.emissive_tex_image))


def lane_counts(rs, config, pose, width, height, spp, word, device):
    """Each bounce's counts of one sample of the frame at `pose`, on every
    k-th pixel and scaled to the whole frame: what the kernels' byte and
    operation counts take."""
    n = width * height
    k = max(1, n // COUNT_PIXELS)
    pix = np.arange(0, n, k, dtype=np.int32)
    counts = []
    check.render_ref(rs, config, [pose], pix, 1, word, width, height, device,
                     counts=counts)
    scale = n / pix.shape[0]
    return [{key: v * scale for key, v in c.items()} for c in counts]


def run(cell: core.Cell, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda", size=None, control=False,
        frames_cls=Frames):
    """One run of a render cell: (result dict, extra readings)."""
    import torch
    spans = core.Spans()
    frames = frames_cls(cell, seed, spans, device, size)
    lim = cell.limits
    pix = check.pixels(frames.width, frames.height, lim["check_pixels"], seed)
    with spans("warmup"):
        for i in range(2):
            frames.frame(i)
    setup_s = time.perf_counter() - t_start
    lat, kept, win_s, tr = window(frames, seconds, spans, pix, traced)
    n = len(lat)
    dev = core.device(cell.chips) if device == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    frames.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    return finish(cell, seed, spans, lat, kept, win_s, tr, setup_s, dev,
                  pix, frames, device, control)


def finish(cell, seed, spans, lat, kept, win_s, tr, setup_s, dev, pix,
           plan, device, control, busy=None, nccl_us=None):
    """The check and the metrics of a render run: (result, extra).
    `busy`, `nccl_us`: the ranks' mean busy seconds and each rank's NCCL
    kernels' times in order (us) in the traced frames, where the frame
    spans cards."""
    lim = cell.limits
    n = len(lat)
    c = cell.config
    t_check = time.perf_counter()
    W, H, spp, word = plan.width, plan.height, plan.spp, plan.word
    rs = check.ref_scene(plan.recipe, c, seed, device)
    sel = check.pick(n, lim["check_frames"], seed)
    poses = [plan.pose(2 + i) for i in sel]
    want = check.render_ref(rs, c, poses, pix, spp, word, W, H, device)
    got = np.stack([kept[i] for i in sel])
    gaps = check.frame_gaps(got, want)
    values = {"image_gap": float(np.max(gaps))}
    failed = int(np.sum(~(gaps <= lim["limits"]["image_gap"])))
    extra = {}
    if control:
        low = check.render_ref(rs, c, poses, pix, spp, word, W, H, device,
                               lower=check.bf16)
        extra["control_image_gap"] = check.image_gap(low, want)
    correct = check.passes(values, lim["limits"])
    extra["check_s"] = time.perf_counter() - t_check
    metrics = {}
    breakdown = None
    if tr is None:
        for m in cell.end_to_end:
            if m["name"] == "render_rays_per_s":
                metrics[m["name"]] = core.metric(W * H * spp * n / win_s,
                                                 m["unit"])
            elif m["name"] == "frame_ms_p95":
                metrics[m["name"]] = core.metric(
                    core.percentile(lat, 95) * 1e3, m["unit"])
            elif m["name"] == "setup_s":
                metrics[m["name"]] = core.metric(setup_s, m["unit"])
    else:
        # every render cell's config takes the fused bounce (no atlas, or
        # the pair atlas)
        ctx = dict(trace=tr, units=TRACED_FRAMES, spans=spans, lanes=W * H,
                   spp=spp, route="fused", backward=False,
                   scene=scene_dims(rs), nccl_us=nccl_us,
                   bounces=lane_counts(rs, c, poses[0], W, H, spp, word,
                                       device))
        for m in cell.per_layer:
            v = core.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = core.metric(v, m["unit"])
        win_us = tr.end - tr.start
        dev = dict(dev, busy_s=(busy if busy is not None
                                else trace.busy_us(tr) * 1e-6),
                   window_s=win_us * 1e-6)
        breakdown = trace.breakdown(tr)
        extra["bound_by"] = {k: rooflines.bound_by(ctx, k)
                             for k in ("b1", "b2", "b5", "b6")}
        if nccl_us is not None:
            extra["nccl_ms_per_rank"] = [sum(us) * 1e-3 / TRACED_FRAMES
                                         for us in nccl_us]
    extra.update(spans=span_totals(spans), frames=n, window_s=win_s,
                 setup_s=setup_s, ms_by_fifth=ms_by_fifth(spans, "frame"),
                 p50_ms=core.percentile(lat, 50) * 1e3)
    res = core.result(correct, n, failed if failed else int(not correct),
                      metrics, dev,
                      check.compared(values, lim["limits"]), breakdown)
    return res, extra


def span_totals(spans: core.Spans) -> dict:
    return {name: spans.seconds(name) for name in {s[0] for s in spans.spans}}


def ms_by_fifth(spans: core.Spans, name: str) -> list:
    """The window's ms a frame or step in each fifth of its frames or
    steps (the spread inside a run, beside the spread between runs)."""
    ss = [(t0, t1) for n, t0, t1 in spans.spans if n == name]
    k = len(ss) // 5
    return [(ss[j * k + k - 1][1] - ss[j * k][0]) * 1e3 / k
            for j in range(5)] if k else []
