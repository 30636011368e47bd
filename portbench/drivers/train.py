"""Inverse rendering as `tracer_torch.train.fit` runs it: the step object
of `train.make_step` (the render at the traffic's samples, the L2 loss
against a target image, the backward, the grad norm, one graph a step
on the card, then Adam's update), one step a call with its loss and
grad norm read to the host as `fit` reads them. Each step draws new
samples (its own seed), so no two steps trace the same rays.

Set-up builds the scene, renders the target from the true scene, moves
the trainable fields from it by seeded offsets, builds the optimizer and
the step, and drives that same step object through the first
`checked_steps` steps (the first captures the step's graph): their
losses, Adam's first moment after step 1 and the parameters after the
last are the check's readings. The window then takes the steps that
follow. After it the program's state is freed and the reference runs
the same steps from the same start values (`check.py`)."""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np

from portbench import check, core, rooflines, trace
from portbench.drivers.render import (lane_counts, ms_by_fifth, scene_dims,
                                      span_totals)

TRACED_STEPS = 3
BETAS, EPS = (0.9, 0.999), 1e-8     # optax.adam's defaults, as `fit` uses


def target_word(word: int) -> int:
    """The target render's seed word: another stream than every step's."""
    return (word ^ 0x5BD1E995) % 2 ** 32


def step_word(word: int, i: int) -> int:
    return (word + 1 + i) % 2 ** 32


class Steps:
    """The program's side of a training cell."""

    def __init__(self, cell: core.Cell, seed: int, spans: core.Spans,
                 device: str, size=None):
        import torch
        with spans("imports"):
            from tracer_torch import train as T
            from tracer_torch.core.config import RenderConfig
            from tracer_torch.render import renderer
            from tracer_torch.render.camera import Camera
            from tracer_torch.scene import builder as TB
            from tracer_torch.scene.device import compile_scene

        c, trf = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.width, self.height = size or (c["width"], c["height"])
        self.spp = trf["spp"]
        self.word = seed % 2 ** 32
        self.recipe = importlib.import_module(f"portbench.scenes.{c['scene']}")
        if device == "cuda":
            from tracer_torch.kernels import _build
            with spans("load_kernels"):
                _build.library()
        with spans("scene_build"):
            scene = compile_scene(self.recipe.build(TB, c, seed),
                                  leaf_width=c["bvh_leaf_size"],
                                  device=device)
            if device == "cuda":
                torch.cuda.synchronize()
        self.pose = np.asarray(
            c["camera"]["position"] + [1.0, 0.0, 0.0, 0.0], np.float32)
        f = dict(dtype=torch.float32, device=device)
        cam = Camera(torch.tensor(self.pose[:3], **f),
                     torch.tensor(self.pose[3:], **f),
                     torch.tensor(c["camera"]["fov_deg"], **f),
                     torch.tensor(self.width / self.height, **f))
        cfg = T.guard_config(RenderConfig(
            nsamples=self.spp, width=self.width, height=self.height,
            max_bounces=c["max_bounces"], shadow_rays=c["shadow_rays"],
            compat=c["compat"], seed=self.word), trf["trainable"])
        self.pid = torch.arange(self.width * self.height, dtype=torch.int32,
                                device=device)
        with spans("target"):
            self.target = renderer.render_frame(
                scene, cam, cfg, self.width, self.height, self.pid,
                self.spp, target_word(self.word)) / self.spp
        # the start: each trainable field moved by a seeded normal offset,
        # drawn on the device in the leaves' sorted order
        with spans("inputs"):
            gen = torch.Generator(device=device).manual_seed(seed)
            true = T.split_params(scene, cam, trf["trainable"])
            self.start = {}
            for k in sorted(true):
                v = true[k].detach()
                self.start[k] = v + trf["offsets"][k] * torch.randn(
                    tuple(v.shape), generator=gen, device=device)
            self.params = {k: v.clone().requires_grad_(True)
                           for k, v in self.start.items()}
            self.opt = torch.optim.Adam([self.params[k] for k in sorted(
                self.params)], lr=trf["lr"], betas=BETAS, eps=EPS)
            self.step_fn = T.make_step(self.opt, cfg, self.target,
                                       self.width, self.height, self.spp)
        self.scene, self.cam = scene, cam
        self.i = 0

    def step(self):
        """One step, its loss and grad norm read to the host."""
        loss, gnorm = self.step_fn(self.params, self.scene, self.cam,
                                   self.pid, step_word(self.word, self.i))
        self.i += 1
        return float(loss), float(gnorm)

    def grad1(self) -> dict:
        """The first step's gradient as Adam holds it: its first moment
        after one step over (1 - beta1); zeros where the step left no
        moment."""
        import torch
        return {k: self.opt.state[p]["exp_avg"].detach().clone()
                / (1.0 - BETAS[0]) if "exp_avg" in self.opt.state.get(p, {})
                else torch.zeros_like(p) for k, p in self.params.items()}

    def release(self):
        self.scene = self.cam = self.params = self.opt = None
        self.step_fn = self.target = None


def ref_steps(cell, seed, start, word, width, height, spp, device, n,
              lower=None):
    """The reference's n steps from `start`: its own scene and target,
    plain autograd and torch's Adam with `fit`'s hyperparameters."""
    import torch
    from portbench.reference import render as RR
    c, trf = cell.config, cell.traffic
    recipe = importlib.import_module(f"portbench.scenes.{c['scene']}")
    rs = check.ref_scene(recipe, c, seed, device)
    cfg = check.ref_config(c, spp, word, width, height)
    cam = RR.camera(np.asarray(c["camera"]["position"] + [1.0, 0.0, 0.0,
                                                          0.0], np.float32),
                    c["camera"]["fov_deg"], width / height, device)
    pid = torch.arange(width * height, dtype=torch.int32, device=device)
    with torch.no_grad():
        target = RR.render_views(rs, [(cam, pid)], cfg, width, height, spp,
                                 target_word(word), lower=lower) / spp
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    opt = torch.optim.Adam([params[k] for k in sorted(params)],
                           lr=trf["lr"], betas=BETAS, eps=EPS)
    losses, grad1 = [], None
    for i in range(n):
        opt.zero_grad(set_to_none=True)
        s = dataclasses.replace(rs, **params)
        img = RR.render_views(s, [(cam, pid)], cfg, width, height, spp,
                              step_word(word, i), lower=lower) / spp
        loss = torch.sum((img - target) ** 2) / float(pid.numel() * 3)
        loss.backward()
        losses.append(float(loss.detach()))
        opt.step()
        if i == 0:
            grad1 = {k: opt.state[p]["exp_avg"].detach().clone()
                     / (1.0 - BETAS[0]) for k, p in params.items()}
    change = {k: params[k].detach() - start[k] for k in params}
    return {"losses": losses, "grad1": grad1, "change": change}, rs


def run(cell: core.Cell, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda", size=None, control=False,
        steps_cls=Steps):
    import torch
    spans = core.Spans()
    n_chk = cell.traffic["checked_steps"]
    st = steps_cls(cell, seed, spans, device, size)
    losses = []
    with spans("warmup"):
        losses.append(st.step()[0])
    grad1 = st.grad1()
    with spans("checked_steps"):
        for _ in range(n_chk - 1):
            losses.append(st.step()[0])
    prog = {"losses": losses, "grad1": grad1,
            "change": {k: st.params[k].detach() - st.start[k]
                       for k in st.params}}
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    tr = None
    n = 0
    start = time.perf_counter()
    if traced:
        with spans("step"):
            st.step()
        n += 1

        def traced_steps():
            for _ in range(TRACED_STEPS):
                with spans("step"):
                    st.step()
        tr = trace.record(traced_steps, spans, "steps")
        n += TRACED_STEPS
    while True:
        with spans("step"):
            st.step()
        n += 1
        if time.perf_counter() - start >= seconds:
            break
    win_s = time.perf_counter() - start
    dev = core.device(cell.chips) if device == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    W, H, spp, word = st.width, st.height, st.spp, st.word
    start_vals = {k: v.detach() for k, v in st.start.items()}
    st.release()
    if device == "cuda":
        torch.cuda.empty_cache()

    lim = cell.limits
    t_check = time.perf_counter()
    ref, rs = ref_steps(cell, seed, start_vals, word, W, H, spp, device,
                        n_chk)
    values = check.train_gaps(prog, ref)
    extra = {"losses": losses, "ref_losses": ref["losses"],
             "check_s": time.perf_counter() - t_check}
    if control:
        low, _ = ref_steps(cell, seed, start_vals, word, W, H, spp, device,
                           n_chk, lower=check.bf16)
        extra["control"] = check.train_gaps(low, ref)
    correct = check.passes(values, lim["limits"])
    metrics, breakdown = {}, None
    if tr is None:
        for m in cell.end_to_end:
            if m["name"] == "train_step_ms":
                metrics[m["name"]] = core.metric(win_s * 1e3 / n, m["unit"])
            elif m["name"] == "setup_s":
                metrics[m["name"]] = core.metric(setup_s, m["unit"])
    else:
        ctx = dict(trace=tr, units=TRACED_STEPS, spans=spans, lanes=W * H,
                   spp=spp, route="general", backward=True,
                   scene=scene_dims(rs),
                   bounces=lane_counts(rs, cell.config, st.pose, W, H, spp,
                                       word, device))
        for m in cell.per_layer:
            v = core.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = core.metric(v, m["unit"])
        dev = dict(dev, busy_s=trace.busy_us(tr) * 1e-6,
                   window_s=(tr.end - tr.start) * 1e-6)
        breakdown = trace.breakdown(tr)
        extra["bound_by"] = {k: rooflines.bound_by(ctx, k)
                             for k in ("b1", "b3", "b4")}
    extra.update(spans=span_totals(spans), steps=n, window_s=win_s,
                 setup_s=setup_s, ms_by_fifth=ms_by_fifth(spans, "step"))
    res = core.result(correct, n_chk + n, 0 if correct else 1, metrics, dev,
                      check.compared(values, lim["limits"]), breakdown)
    return res, extra
