"""The port's training loop (`tracer_torch/train.py`) against the JAX
package's (`tracer/train.py`), on the CPU, at the size of
`tests/test_train.py` (48x32, 2 spp, 1-2 bounces, a few steps).

- The hand-written backward fed by the exact-atlas (general-route)
  forward: `fit` renders with `packed_atlas="off"` while texels train, and
  the textured Cornell still takes the hand-written sweep, so its gradients
  are held against `jax.grad` of the same loss (op by op under
  `jax.disable_jit`, as tests/test_torch_general_bwd.py runs it).
- One Adam update against optax.adam's, fresh and from a restored count.
- `fit` against `tracer.train.fit`: losses within LOSS_RTOL, params within
  PARAM_ATOL, except at components whose first JAX gradient is below
  TIE_SHARE of its leaf's largest (Adam's first update is about
  lr * sign(g), so a gradient that is zero up to f32 summation order may
  step either way); those may differ by more at most TIE_BUDGET times.
  Measured on this scene: 21 such components (the padding rows of
  sph_center, whose gradient is exactly 0 in both packages) and 0 of them
  off by more than PARAM_ATOL; losses within 2e-7 relative, params within
  4.1e-7.
- Checkpoints: a `tracer` checkpoint resumes in the port and the reverse;
  the port's own resume is bit-exact.
- Mirrors of tests/test_train.py: albedo and camera-orientation recovery
  (the first 3 steps of the latter held against JAX), the stale-pack
  guard.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tracer import train as JT
from tracer.core.config import RenderConfig as JConfig
from tracer.render import camera as jcam
from tracer.render import renderer as jrenderer
from tracer.scene.builder import Material, SceneBuilder
from tracer.scene.device import compile_scene as jcompile
from tracer.scenes import zoo as jzoo
from tracer_torch import train as TT
from tracer_torch.core import rng as trng
from tracer_torch.core.config import RenderConfig as TConfig
from tracer_torch.render import camera as tcam
from tracer_torch.render import integrator as tintegrator
from tracer_torch.render import renderer as trenderer
from tracer_torch.scene import device as tdevice
from tracer_torch.testing import fill_cornell_textures

W, H, SPP = 48, 32, 2
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
TIE_SHARE = 1e-3
TIE_BUDGET = 2
KW = dict(trainable=["sph_center", "mat_diffuse"], lr=1e-2, width=W,
          height=H, nsamples=SPP)


def port_scene(js):
    fields = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name not in tdevice._META}
    return tdevice.device_scene_from_numpy(
        fields, {k: getattr(js, k) for k in tdevice._META}, device="cpu")


def _scene():
    """tests/test_train.py::_scene: a lit sphere on a floor, open sky."""
    sb = SceneBuilder()
    sb.dark_sky = False
    sb.add_light((-2., 4., 3.), radius=0.0)
    sb.add_sphere((0., 0., 0.), 1.0, Material(diffuse=(0.8, 0.3, 0.2)))
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8., 8.,
                      Material(diffuse=(0.3, 0.6, 0.9)))
    s.rotate_x(-90).translate((0., -1.5, 0.))
    return jcompile(sb)


def jcams():
    return jcam.default_camera(aspect=W / H)


def tcams():
    return tcam.default_camera(W / H, device="cpu")


def _target(js, cfg):
    pid = jnp.arange(W * H, dtype=jnp.int32)
    return np.asarray(jrenderer.render_pixels(
        js, jcams(), cfg, W, H, pid, SPP, jax.random.key(0)) / SPP)


@pytest.fixture(scope="module")
def fit_case():
    """The resume case of tests/test_train.py: the true scene's target,
    a start with the sphere moved and the albedos raised, and JAX's
    uninterrupted 6-step run with its first gradient."""
    js = _scene()
    jcfg = JConfig(width=W, height=H, nsamples=SPP, max_bounces=2,
                   shadow_rays=2)
    target = _target(js, jcfg)
    js0 = dataclasses.replace(
        js, sph_center=js.sph_center.at[0].add(0.1),
        mat_diffuse=js.mat_diffuse + 0.05)
    sj6, _, hj6 = JT.fit(js0, jcams(), jcfg, target, steps=6,
                         base_key=jax.random.key(1), **KW)
    pid = jnp.arange(W * H, dtype=jnp.int32)

    def loss(p):
        s = dataclasses.replace(js0, **p)
        img = jrenderer.render_pixels(s, jcams(), jcfg, W, H, pid, SPP,
                                      jax.random.key(1)) / SPP
        return jnp.mean((img - target.reshape(-1, 3)) ** 2)

    g0 = jax.grad(loss)({k: getattr(js0, k) for k in KW["trainable"]})
    tcfg = TConfig(width=W, height=H, nsamples=SPP, max_bounces=2,
                   shadow_rays=2)
    return dict(js0=js0, ts0=port_scene(js0), jcfg=jcfg, tcfg=tcfg,
                target=target, sj6=sj6, hj6=hj6,
                g0={k: np.asarray(v) for k, v in g0.items()})


def assert_params_close(got, want, g0):
    """Params within PARAM_ATOL, but for at most TIE_BUDGET components
    whose first JAX gradient is below TIE_SHARE of the leaf's largest."""
    ties = 0
    for k, g in g0.items():
        d = np.abs(np.asarray(got[k], np.float64)
                   - np.asarray(want[k], np.float64))
        small = np.abs(g) < TIE_SHARE * np.abs(g).max()
        assert (d[~small] <= PARAM_ATOL).all(), (k, d.max())
        ties += int((d[small] > PARAM_ATOL).sum())
    assert ties <= TIE_BUDGET, ties


def scene_params(scene, names):
    return {k: (getattr(scene, k).numpy() if torch.is_tensor(
        getattr(scene, k)) else np.asarray(getattr(scene, k)))
        for k in names}


@pytest.mark.parametrize("compat", ["reference", "physical"])
def test_packed_off_hand_backward_matches_jax(compat):
    """The textured Cornell under packed_atlas="off": the general-route
    record forward feeds the hand-written sweep (both packages gate the
    sweep on the scene alone); tex_data and mat_diffuse gradients against
    jax.grad, rtol 1e-4 / atol 1e-4 * max|g|."""
    w, h, spp, names = 12, 8, 2, ("tex_data", "mat_diffuse")
    js = jcompile(fill_cornell_textures(jzoo.setup_cornell_box(w / h)))
    ts = port_scene(js)
    jcfg = JConfig(compat=compat, kernels="off", packed_atlas="off",
                   max_bounces=3)
    tcfg = TConfig(compat=compat, packed_atlas="off", max_bounces=3)
    assert not tintegrator._fused(ts, tcfg)
    assert tintegrator.replay_bwd.hand_bwd_ok(ts, tcfg)
    pid = jnp.arange(w * h, dtype=jnp.int32)

    def loss(*params):
        s2 = dataclasses.replace(js, **dict(zip(names, params)))
        acc = sum(jrenderer._render_batch(
            s2, jcam.default_camera(w / h), jcfg, w, h, pid, jnp.int32(s),
            jax.random.key(0)) for s in range(spp))
        return jnp.mean(acc / spp)

    with jax.disable_jit():
        want = jax.grad(loss, argnums=(0, 1))(
            *(getattr(js, k) for k in names))
    params = {k: getattr(ts, k).clone().requires_grad_(True) for k in names}
    trenderer.render_pixels(
        dataclasses.replace(ts, **params), tcam.default_camera(w / h,
                                                               device="cpu"),
        tcfg, w, h, torch.arange(w * h, dtype=torch.int32), spp,
        0).div(spp).mean().backward()
    for k, wv in zip(names, want):
        wv = np.asarray(wv)
        got = params[k].grad.numpy()
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, wv, rtol=1e-4,
                                   atol=1e-4 * np.abs(wv).max(), err_msg=k)
    assert np.abs(params["tex_data"].grad.numpy()).max() > 0.0


@pytest.mark.parametrize("count", [0, 5])
def test_adam_update_matches_optax(count, tmp_path):
    """One update from the same params, gradients and (for count 5) Adam
    state, the latter restored from a checkpoint the JAX package wrote:
    within 2 ulp of the result (torch divides the step size by the bias
    corrections, optax corrects the moments). The params have magnitudes
    0.5-2, where an ulp of the result is the rounding scale of the
    update; a result near 0 would count an ulp of the update as
    thousands."""
    rs = np.random.RandomState(count)

    def mag(shape):
        return (rs.uniform(0.5, 2.0, shape)
                * rs.choice([-1.0, 1.0], shape)).astype(np.float32)

    p0 = {"a": mag((64, 3)), "b": mag((8,))}
    opt = optax.adam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = opt.init(jp)
    for _ in range(count):
        g = {k: jnp.asarray(rs.normal(size=v.shape).astype(np.float32))
             for k, v in p0.items()}
        upd, st = opt.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
    path = str(tmp_path / "train.npz")
    JT._save_ckpt(path, count, jp, st)
    g = {k: rs.normal(size=v.shape).astype(np.float32) * 1e-2
         for k, v in p0.items()}
    upd, _ = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
    want = optax.apply_updates(jp, upd)

    tp = {k: torch.zeros(v.shape, requires_grad=True) for k, v in p0.items()}
    topt = TT._adam_default(1e-2)([tp[k] for k in sorted(tp)])
    assert TT._load_ckpt(path, tp, topt) == count
    for k in tp:
        tp[k].grad = torch.from_numpy(g[k])
    topt.step()
    for k in tp:
        np.testing.assert_array_max_ulp(tp[k].detach().numpy(),
                                        np.asarray(want[k]), maxulp=2)


def test_fit_matches_jax(fit_case):
    c = fit_case
    sj, _, hj = JT.fit(c["js0"], jcams(), c["jcfg"], c["target"], steps=3,
                       base_key=jax.random.key(1), **KW)
    st, _, ht = TT.fit(c["ts0"], tcams(), c["tcfg"], c["target"], steps=3,
                       seed=1, **KW)
    assert [h["step"] for h in ht] == [1, 2, 3]
    for a, b in zip(hj, ht):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                   rtol=LOSS_RTOL)
    assert ht[-1]["loss"] != ht[0]["loss"]
    names = KW["trainable"]
    assert_params_close(scene_params(st, names), scene_params(sj, names),
                        c["g0"])


def test_jax_checkpoint_resumes_in_port(fit_case, tmp_path):
    c = fit_case
    ck = str(tmp_path / "ck")
    JT.fit(c["js0"], jcams(), c["jcfg"], c["target"], steps=3, ckpt_dir=ck,
           ckpt_every=3, base_key=jax.random.key(1), **KW)
    st, _, ht = TT.fit(c["ts0"], tcams(), c["tcfg"], c["target"], steps=6,
                       ckpt_dir=ck, ckpt_every=3, seed=1, **KW)
    assert ht[0]["step"] == 4, "resume must continue at step 4"
    for a, b in zip(c["hj6"][3:], ht):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_RTOL)
    names = KW["trainable"]
    assert_params_close(scene_params(st, names),
                        scene_params(c["sj6"], names), c["g0"])


def test_port_checkpoint_reads_and_resumes_in_jax(fit_case, tmp_path):
    c = fit_case
    ck = str(tmp_path / "ck")
    st, _, _ = TT.fit(c["ts0"], tcams(), c["tcfg"], c["target"], steps=3,
                      ckpt_dir=ck, ckpt_every=3, seed=1, **KW)
    names = KW["trainable"]
    jparams = JT.split_params(c["js0"], jcams(), names)
    jstate = optax.adam(KW["lr"]).init(jparams)
    step, (p, ost) = JT._load_ckpt(os.path.join(ck, "train.npz"), jparams,
                                   jstate)
    assert step == 3 and int(ost[0].count) == 3
    for k in names:
        np.testing.assert_array_equal(np.asarray(p[k]),
                                      getattr(st, k).numpy())
        assert np.isfinite(np.asarray(ost[0].nu[k])).all()
    assert float(jnp.abs(ost[0].mu["mat_diffuse"]).max()) > 0.0
    sj, _, hj = JT.fit(c["js0"], jcams(), c["jcfg"], c["target"], steps=6,
                       ckpt_dir=ck, ckpt_every=3, base_key=jax.random.key(1),
                       **KW)
    assert hj[0]["step"] == 4
    assert_params_close(scene_params(sj, names),
                        scene_params(c["sj6"], names), c["g0"])


def test_fit_exact_resume(fit_case, tmp_path):
    """The port's own resume: params and Adam moments bit-equal to the
    uninterrupted run."""
    c = fit_case
    args = (c["ts0"], tcams(), c["tcfg"], c["target"])
    sa, _, _ = TT.fit(*args, steps=5, seed=1, **KW)
    ck = str(tmp_path / "ck")
    TT.fit(*args, steps=3, ckpt_dir=ck, ckpt_every=3, seed=1, **KW)
    ck5 = str(tmp_path / "ck5")
    sb, _, hb = TT.fit(*args, steps=5, ckpt_dir=ck, ckpt_every=5, seed=1,
                       **KW)
    assert hb[0]["step"] == 4
    for k in KW["trainable"]:
        np.testing.assert_array_equal(getattr(sa, k).numpy(),
                                      getattr(sb, k).numpy())
    # the moments too: an uninterrupted run's checkpoint
    TT.fit(*args, steps=5, ckpt_dir=ck5, ckpt_every=5, seed=1, **KW)
    with np.load(os.path.join(ck, "train.npz")) as za, \
            np.load(os.path.join(ck5, "train.npz")) as zb:
        assert int(za["step"]) == int(zb["step"]) == 5
        assert sorted(za.files) == sorted(zb.files)
        for f in za.files:
            np.testing.assert_array_equal(za[f], zb[f], err_msg=f)


def test_fit_recovers_albedo():
    """Mirror of tests/test_train.py::test_fit_recovers_albedo."""
    ts = port_scene(_scene())
    cfg = TConfig(width=W, height=H, nsamples=SPP, max_bounces=2,
                  shadow_rays=2)
    pid = torch.arange(W * H, dtype=torch.int32)
    target = trenderer.render_pixels(ts, tcams(), cfg, W, H, pid, SPP,
                                     0) / SPP
    true_d = ts.mat_diffuse
    s0 = dataclasses.replace(ts, mat_diffuse=torch.clamp(
        ts.mat_diffuse + torch.tensor([[0.15, -0.1, 0.08]]), 0.0, 1.0))
    err0 = float((s0.mat_diffuse - true_d).abs().max())
    s1, _, hist = TT.fit(s0, tcams(), cfg, target, ["mat_diffuse"],
                         steps=30, lr=2e-2, width=W, height=H, nsamples=SPP,
                         seed=0)
    err1 = float((s1.mat_diffuse - true_d).abs().max())
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.5, hist
    assert err1 < err0 * 0.6, (err0, err1)
    assert all(np.isfinite(h["grad_norm"]) for h in hist)


def test_fit_recovers_camera_orientation():
    """Mirror of tests/test_train.py::test_fit_recovers_camera_orientation
    (the procedural sky: pitch and roll observable, yaw in the null
    space), its first 3 steps held against JAX: the quaternion's gradient
    reaches it only through generate_rays, from the rays' cotangents."""
    sb = SceneBuilder()
    sb.dark_sky = False
    js = jcompile(sb)
    ts = port_scene(js)
    jcfg = JConfig(width=W, height=H, nsamples=SPP, max_bounces=1)
    tcfg = TConfig(width=W, height=H, nsamples=SPP, max_bounces=1)
    target = _target(js, jcfg)
    q_off = [0.9995, 0.025, 0.0, 0.015]
    jcam0 = dataclasses.replace(jcams(), quaternion=jnp.asarray(
        q_off, jnp.float32))
    tcam0 = dataclasses.replace(tcams(), quaternion=torch.tensor(q_off))
    kw = dict(lr=2e-3, width=W, height=H, nsamples=SPP)
    _, cj, hj = JT.fit(js, jcam0, jcfg, target, ["cam_quaternion"], steps=3,
                       base_key=jax.random.key(0), **kw)
    _, c3, h3 = TT.fit(ts, tcam0, tcfg, target, ["cam_quaternion"], steps=3,
                       seed=0, **kw)
    for a, b in zip(hj, h3):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                   rtol=1e-4)
    np.testing.assert_allclose(c3.quaternion.numpy(),
                               np.asarray(cj.quaternion), atol=PARAM_ATOL)

    _, cam1, hist = TT.fit(ts, tcam0, tcfg, target, ["cam_quaternion"],
                           steps=50, seed=0, **kw)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.05, (hist[0], hist[-1])
    q1 = cam1.quaternion.numpy().astype(np.float64)
    q1 = q1 / np.linalg.norm(q1)
    assert abs(q1[1]) < 0.025 * 0.5, q1
    assert abs(q1[3]) < 0.015 * 0.5, q1
    assert np.isfinite(q1).all()


def test_texel_training_stale_pack_guard():
    """Mirror of tests/test_train.py::test_texel_training_stale_pack_guard:
    the returned scene's packed twins are invalidated, so every later
    render takes the exact-atlas route and equals the packed_atlas="off"
    render, while the stale packs would have given another image."""
    sb = SceneBuilder()
    sb.dark_sky = False
    sb.add_light((0., 0., 5.), radius=0.0)
    img = (np.arange(8 * 8 * 3).reshape(8, 8, 3) * 2 + 30).astype(np.uint8)
    mt = Material(diffuse=(1., 1., 1.))
    mt.texture_type = 2
    mt.texture_id = sb.add_texture(img)
    sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 4., 4., mt)
    ts = port_scene(jcompile(sb))
    assert ts.tex_pack.shape[0] > 1
    cfg = TConfig(width=W, height=H, nsamples=SPP, max_bounces=1,
                  shadow_rays=1)
    assert TT.guard_config(cfg, ["tex_data"]).packed_atlas == "off"
    pid = torch.arange(W * H, dtype=torch.int32)
    target = trenderer.render_pixels(
        ts, tcams(), TT.guard_config(cfg, ["tex_data"]), W, H, pid, SPP,
        0) / SPP
    s0 = dataclasses.replace(ts, tex_data=ts.tex_data * 0.7)
    s1, _, hist = TT.fit(s0, tcams(), cfg, target, ["tex_data"], steps=3,
                         lr=5e-2, width=W, height=H, nsamples=SPP, seed=0)
    assert len(hist) == 3
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert not s1.pair_mode and s1.tex_pack.shape == (1, 16)
    assert s1.pair_pack.shape == (1, 32) and s1.sky_pack.shape == (1, 16)

    n = 64
    u = torch.linspace(0.3, 0.7, n)
    v = torch.linspace(0.4, 0.6, n)
    o, d = tcam.generate_rays(tcams(), u, v)
    keys = trng.ray_keys(2, torch.arange(n))
    tm = torch.zeros(n)

    def rad(scene, **kw):
        return tintegrator.trace(scene, dataclasses.replace(cfg, **kw), o,
                                 d, tm, keys).numpy()

    r_auto = rad(s1)
    np.testing.assert_array_equal(r_auto, rad(s1, packed_atlas="off"))
    np.testing.assert_array_equal(r_auto, rad(s1, kernels="off"))
    stale = dataclasses.replace(s1, tex_pack=ts.tex_pack)
    assert not np.array_equal(r_auto, rad(stale))
    # the texels left the u8 grid during training
    assert float((s1.tex_data - ts.tex_data).abs().max()) > 1e-4


def test_fit_mesh_raises(fit_case, tmp_path):
    """`fit(mesh=)` (it raised before the sharded step was ported; the
    name is kept): on the (1, 1) mesh, which needs no process group, it is
    `fit()` bit for bit, and its checkpoint resumes unsharded onto the
    same trajectory. The multi-rank meshes: tests/test_torch_dist.py."""
    from tracer_torch.dist.sharding import make_ray_mesh

    c = fit_case
    args = (tcams(), c["tcfg"], c["target"])
    s0, _, h0 = TT.fit(c["ts0"], *args, steps=2, seed=1, **KW)
    ck = str(tmp_path / "ck")
    s1, _, h1 = TT.fit(c["ts0"], *args, steps=1, seed=1, ckpt_dir=ck,
                       mesh=make_ray_mesh(1, 1), **KW)
    s2, _, h2 = TT.fit(c["ts0"], *args, steps=2, seed=1, ckpt_dir=ck, **KW)
    assert [h["loss"] for h in h1 + h2] == [h["loss"] for h in h0]
    for k in KW["trainable"]:
        np.testing.assert_array_equal(getattr(s2, k).numpy(),
                                      getattr(s0, k).numpy())


def test_checkpoint_mismatch_raises(fit_case, tmp_path):
    """A checkpoint of another trainable set: every leaf's shape and dtype
    is checked before anything is restored."""
    c = fit_case
    ck = str(tmp_path / "ck")
    JT.fit(c["js0"], jcams(), c["jcfg"], c["target"], steps=1, ckpt_dir=ck,
           base_key=jax.random.key(1), **KW)
    with pytest.raises(ValueError, match="trainable set or scene changed"):
        TT.fit(c["ts0"], tcams(), c["tcfg"], c["target"], steps=2,
               ckpt_dir=ck, seed=1, **{**KW, "trainable": ["mat_diffuse"]})
