"""The check's controls and faults, on the CPU at a small size: the
reference in bfloat16 in the program's place, and the harness driven with
the timed path broken underneath, each come out as not correct, while
the program as it is comes out correct."""

import numpy as np
import pytest

from portbench import check
from portbench.tests import helpers


def test_render_program_passes_and_its_control_fails():
    cell = helpers.small_cell("cornell.render")
    res, extra = helpers.run(cell, control=True)
    lim = cell.limits["limits"]["image_gap"]
    assert res["correct"] is True
    assert res["compared"]["image_gap"]["value"] <= lim
    assert extra["control_image_gap"] > lim


def test_train_program_passes_and_its_control_fails():
    cell = helpers.small_cell("cornell.train")
    res, extra = helpers.run(cell, control=True)
    assert res["correct"] is True
    assert not check.passes(extra["control"], cell.limits["limits"])


def _stale_camera(monkeypatch):
    """A frame drawn from the previous frame's camera (a cache that keeps
    an old input)."""
    from portbench.drivers import render
    orig = render.Frames.camera
    monkeypatch.setattr(render.Frames, "camera",
                        lambda self, i: orig(self, max(i - 1, 0)))


def _half_samples(monkeypatch):
    """Half the samples left out, the mean taken over the rest."""
    from tracer_torch.render import renderer
    orig = renderer.render_frame

    def half(scene, cam, cfg, w, h, pid, nsamples, seed, *a, **k):
        n = max(nsamples // 2, 1)
        return orig(scene, cam, cfg, w, h, pid, n, seed, *a, **k) * (
            nsamples / n)
    monkeypatch.setattr(renderer, "render_frame", half)


def _no_gamma(monkeypatch):
    """The image altered where it is made: gamma left out."""
    from tracer_torch.render import renderer
    monkeypatch.setattr(renderer, "to_image",
                        lambda mean, w, h, gamma=True: np.clip(
                            mean, 0.0, 1.0).reshape(h, w, 3))


@pytest.mark.parametrize("fault", [_stale_camera, _half_samples, _no_gamma])
def test_render_faults_come_out_not_correct(fault, monkeypatch):
    # the flamingo scene: bright everywhere at a small size, where most of
    # the Cornell box's pixels are black from the start pose
    fault(monkeypatch)
    res, _ = helpers.run(helpers.small_cell("flamingo.render"), seconds=0.5)
    assert res["correct"] is False
    assert res["failed"] >= 1


def _unchanged_state(monkeypatch):
    """A step that leaves the parameters and Adam's state as they were."""
    from tracer_torch import train
    orig = train.make_step

    def make(opt, *a, **k):
        inner = orig(opt, *a, **k)

        def step(params, *b):
            keep = {n: p.detach().clone() for n, p in params.items()}
            st = {p: {k2: v.clone() for k2, v in opt.state[p].items()}
                  for p in params.values() if p in opt.state}
            out = inner(params, *b)
            for n, p in params.items():
                p.data.copy_(keep[n])
                if p in st:
                    opt.state[p] = st[p]
                else:
                    opt.state.pop(p, None)
            return out
        return step
    monkeypatch.setattr(train, "make_step", make)


def _half_pixels(monkeypatch):
    """Half the batch (the pixels) left out, the loss the mean over the
    rest."""
    from tracer_torch import train
    orig = train.make_step

    def make(opt, cfg, target, w, h, n, *a, **k):
        half = target.reshape(-1, 3)[:(w * h) // 2]
        inner = orig(opt, cfg, half, w, h, n, *a, **k)
        return lambda params, scene, cam, pid, seed: inner(
            params, scene, cam, pid[:pid.shape[0] // 2], seed)
    monkeypatch.setattr(train, "make_step", make)


def _altered_loss(monkeypatch):
    """The step's answer altered where it is made: the loss off by 1%."""
    from tracer_torch import train
    orig = train.make_step

    def make(*a, **k):
        inner = orig(*a, **k)

        def step(*b):
            loss, gnorm = inner(*b)
            return loss * 1.01, gnorm
        return step
    monkeypatch.setattr(train, "make_step", make)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_pixels,
                                   _altered_loss])
def test_train_faults_come_out_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res, _ = helpers.run(helpers.small_cell("cornell.train"))
    assert res["correct"] is False


def no_exchange():
    """Each rank keeps its own samples: the sum over sp left out."""
    from tracer_torch.dist import sharding
    sharding._SumOverGroup.apply = staticmethod(lambda x, group: x)


@pytest.mark.parametrize("hook,correct", [(None, True), (no_exchange, False)])
def test_sharded_exchange_left_out_comes_out_not_correct(hook, correct):
    import time
    from portbench import core
    cell = helpers.small_cell("random_spheres.render4", spp=4)
    res, _ = core.driver(cell).run(cell, 2 ** 31 + 5, 1e-6, False,
                                   time.perf_counter(), device="cpu",
                                   size=helpers.SIZE, hook=hook)
    assert res["correct"] is correct
