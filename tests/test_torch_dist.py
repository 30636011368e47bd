"""The port's distribution (`tracer_torch/dist/`) against the JAX
package's on the CPU: spawned gloo groups of 2 and 4 ranks
(`tracer_torch.dist.launch.run`, rank bodies in `tracer_torch.testing`,
so no rank imports jax) against `tracer.dist` on the forced 8-device CPU
mesh of tests/conftest.py, same mesh shapes.

- The sharded blocks (and the film gathered over dp) equal JAX's
  `render_pixels_sharded`: tests/test_dist.py's tiny scene without its
  light at atol 2e-5, and with it, each under a counted-ties budget (as
  tests/test_torch_render_lit.py): XLA:CPU contracts multiply-adds in
  jitted code, and JAX's jitted render of the unlit scene differs from
  its own op-by-op render by 2.32e-5 at one value, where the port equals
  the op-by-op render (1.2e-7).
- The sharded gradients of mean(image ** 2) (mat_diffuse, sph_center)
  equal the port's single-device gradients (rtol 1e-4) and JAX's sharded
  gradients (rtol 1e-4, atol 1e-4 * max|g|, but for counted ties, and
  every entry within rtol 1e-2): the sp reduction must not scale them by
  n_sp, and JAX's do not. The ties: JAX's jitted gradient of the mirror
  sphere's centre differs from its own op-by-op gradient by up to 4.96e-5
  (0.4%), where the port's equals the op-by-op one within 1e-9.
- `train_step` on (2, 2) gives JAX's loss and new parameters (rtol 1e-4).
- 2 hosts x 2 ranks: `make_pod_mesh(n_sp=2)` is (2, 2) and
  `render_image_multihost` equals `render` bit for bit.
- `fit(mesh=)` equals `fit()` (bit for bit on (1, 1) in one process,
  rtol 1e-4 on (2, 2)) and its checkpoint resumes unsharded.
- `dryrun_multichip(2, device="cpu")` runs; pixel and sample counts that
  do not split over the mesh raise.

The groups run in the background, one after another, while the JAX
side compiles.
"""

import concurrent.futures
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer.core.config import RenderConfig as JConfig
from tracer.dist import sharding as jsharding
from tracer.render.camera import default_camera as jcamera
from tracer.scene import builder as jbuilder
from tracer.scene.device import compile_scene as jcompile
from tracer_torch import testing as tt
from tracer_torch import train as TT
from tracer_torch.dist import launch
from tracer_torch.dist import sharding
from tracer_torch.dist.dryrun import dryrun_multichip
from tracer_torch.render.renderer import render_pixels

W, H = tt.DIST_W, tt.DIST_H
NS = 4
SHAPES = [(2, 1), (1, 2), (2, 2)]
# values (of 16 * 8 * 3 = 384) of a scene's film that may differ from
# JAX's beyond atol 2e-5; measured: unlit 1 (2.31e-5; the rest within
# 1e-4), lit 0, on every mesh
TIES = dict(unlit=2, lit=4)
# gradient entries (of 24 a leaf) outside rtol 1e-4 / atol 1e-4 * max|g|
# of JAX's; measured: 0 (mat_diffuse), 3 (sph_center: the mirror sphere)
GRAD_TIES = 4


def ties(got, want):
    n = int((np.abs(got - want) > 2e-5).sum())
    assert abs(got.mean() - want.mean()) < 1e-3 * want.mean()
    return n


JCFG = JConfig(width=W, height=H, max_bounces=3, shadow_rays=2)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The spawned groups' results, started in the background one after
    another (each group's ranks split the cores): the 2-rank group on
    (2, 1) and (1, 2), the 4-rank group (2 hosts x 2) on (2, 2) with the
    extra checks, and the dry run."""
    ckpt = str(tmp_path_factory.mktemp("dist_fit"))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    futs = dict(
        two=pool.submit(launch.run, tt.dist_rank, 2,
                        ([(2, 1), (1, 2)], NS), device="cpu"),
        four=pool.submit(launch.run, tt.dist_rank, 4,
                         ([(2, 2)], NS, True, ckpt), device="cpu",
                         local_world_size=2),
        dryrun=pool.submit(dryrun_multichip, 2, "cpu"))
    yield dict(futs=futs, ckpt=ckpt)
    pool.shutdown(wait=True)


def ranks(groups, shape):
    key = "two" if shape[0] * shape[1] == 2 else "four"
    return [r["meshes"][shape] for r in groups["futs"][key].result(600)]


@pytest.fixture(scope="module")
def jax_side():
    """JAX's sharded images and gradients on each mesh shape (one jit per
    mesh and scene), from the same scene tables."""
    out = {}
    cam = jcamera(aspect=W / H)
    pid = jnp.arange(W * H, dtype=jnp.int32)
    key = jax.random.key(0)
    for lit in (False, True):
        js = jcompile(tt.dist_builder(jbuilder, lit))
        for shape in SHAPES:
            mesh = jsharding.make_ray_mesh(*shape)

            def img_of(dif, cen, js=js, mesh=mesh):
                s = dataclasses.replace(js, mat_diffuse=dif, sph_center=cen)
                return jsharding.render_pixels_sharded(
                    s, cam, JCFG, W, H, pid, NS, key, mesh)

            if lit:
                out[shape, "lit"] = (np.asarray(jax.jit(img_of)(
                    js.mat_diffuse, js.sph_center)), None)
                continue

            def loss(dif, cen):
                img = img_of(dif, cen)
                return jnp.mean(img ** 2), img

            (_, img), g = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(js.mat_diffuse,
                                                     js.sph_center)
            out[shape, "unlit"] = (np.asarray(img), dict(
                mat_diffuse=np.asarray(g[0]), sph_center=np.asarray(g[1])))
    return out


@pytest.fixture(scope="module")
def single():
    """The port's unsharded images and gradients (`tt.dist_grads`)."""
    return {name: tt.dist_grads(*tt.dist_scene_camera(name == "lit"), NS)
            for name in ("unlit", "lit")}


def test_one_rank_mesh_is_render_pixels():
    """The (1, 1) mesh needs no process group and renders
    `render_pixels / nsamples` bit for bit; a larger mesh needs a group."""
    scene, cam = tt.dist_scene_camera(True)
    pid = torch.arange(W * H, dtype=torch.int32)
    mesh = sharding.make_ray_mesh(1, 1)
    assert mesh.shape == {"dp": 1, "sp": 1} and mesh.group is None
    got = sharding.render_pixels_sharded(scene, cam, tt.dist_config(), W, H,
                                         pid, NS, 0, mesh)
    want = render_pixels(scene, cam, tt.dist_config(), W, H, pid, NS, 0) / NS
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(RuntimeError, match="process group"):
        sharding.make_ray_mesh(2, 1)


@pytest.mark.parametrize("shape", SHAPES)
def test_blocks_match_jax_unlit(groups, jax_side, shape):
    want, _ = jax_side[shape, "unlit"]
    nb = W * H // shape[0]
    for r in ranks(groups, shape):
        i, _ = r["coord"]
        film = r["unlit"]["film"]
        np.testing.assert_array_equal(r["unlit"]["block"],
                                      film[i * nb:(i + 1) * nb])
        assert ties(film, want) <= TIES["unlit"]
        np.testing.assert_allclose(film, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_blocks_match_jax_lit(groups, jax_side, single, shape):
    """The lit scene (the soft-shadow path), within a counted-ties
    budget; each rank's block is its rows of the gathered film, and with
    one sample block (sp = 1) the film is the unsharded render bit for
    bit."""
    want, _ = jax_side[shape, "lit"]
    nb = W * H // shape[0]
    for r in ranks(groups, shape):
        i, _ = r["coord"]
        film = r["lit"]["film"]
        np.testing.assert_array_equal(r["lit"]["block"],
                                      film[i * nb:(i + 1) * nb])
        n = ties(film, want)
        assert n <= TIES["lit"], f"{n} of {film.size} values differ"
        if shape[1] == 1:
            np.testing.assert_array_equal(film, single["lit"][0])
        else:
            np.testing.assert_allclose(film, single["lit"][0], atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_grads_match_single_device(groups, single, shape):
    for r in ranks(groups, shape):
        for name in ("unlit", "lit"):
            for k, want in single[name][1].items():
                got = r[name]["grads"][k]
                assert np.abs(want).max() > 0, (name, k)
                np.testing.assert_allclose(got, want, rtol=1e-4,
                                           atol=1e-7 * np.abs(want).max(),
                                           err_msg=f"{name} {k}")


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_grads_match_jax(groups, jax_side, shape):
    """JAX's sharded gradients are its single-device ones (no n_sp
    factor); the port's match them on every mesh."""
    _, jg = jax_side[shape, "unlit"]
    for r in ranks(groups, shape):
        for k, want in jg.items():
            got = r["unlit"]["grads"][k]
            off = np.abs(got - want) > (1e-4 * np.abs(want)
                                        + 1e-4 * np.abs(want).max())
            assert off.sum() <= GRAD_TIES, (k, off.sum())
            np.testing.assert_allclose(got, want, rtol=1e-2,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=k)


@pytest.mark.parametrize("shape", SHAPES)
def test_collective_spans(groups, shape):
    """`sharding.collective_spans` records each collective a rank runs:
    the render's sum over sp, the film's gather over dp, the backward's
    none (the sp sum's backward is the identity) and the gradients' one
    all_reduce over the mesh, each with the bytes of the tensor it sends:
    the rank's block for the sum and the gather, every leaf's gradient
    for the last."""
    n_dp, n_sp = shape
    want = (["all_reduce"] * (n_sp > 1) + ["all_gather"] * (n_dp > 1)
            + ["all_reduce"] * (n_sp > 1) + ["all_reduce"])
    for r in ranks(groups, shape):
        for name in ("unlit", "lit"):
            spans = r[name]["spans"]
            assert [op for op, _ in spans] == want, (name, spans)
            blk = r[name]["block"].nbytes
            grads = sum(g.nbytes for g in r[name]["grads"].values())
            assert [b for _, b in spans] == [blk] * (len(want) - 1) + [grads]


@pytest.mark.parametrize("shape", SHAPES)
def test_unsplit_counts_raise(groups, shape):
    """N pixels not split over dp > 1 and nsamples not split over sp > 1
    raise ValueError before any collective (JAX refuses (1, 8) at 4 spp)."""
    for r in ranks(groups, shape):
        assert r["raises"] == [shape[0] > 1, shape[1] > 1]


def test_train_step_matches_jax(groups):
    js = jcompile(tt.dist_builder(jbuilder, False))
    loss, s1, c1 = jax.jit(lambda s, c: jsharding.train_step(
        s, c, JCFG, W, H, jnp.arange(W * H, dtype=jnp.int32),
        jnp.zeros((W * H, 3)), NS, jax.random.key(1),
        jsharding.make_ray_mesh(2, 2)))(js, jcamera(aspect=W / H))
    want = dict(cam_position=np.asarray(c1.position),
                **{k: np.asarray(getattr(s1, k))
                   for k in ("sph_center", "sph_radius", "mat_diffuse",
                             "tex_data", "mesh_verts")})
    res = groups["futs"]["four"].result(600)
    for r in res:
        got = r["train_step"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-4)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    # the step moved the albedos
    scene, _ = tt.dist_scene_camera(False)
    assert np.abs(res[0]["train_step"]["mat_diffuse"]
                  - scene.mat_diffuse.numpy()).max() > 0


def test_pod_mesh_render_image_multihost(groups):
    """2 hosts x 2 ranks (LOCAL_WORLD_SIZE=2): the host-major mesh is
    (dp 2, sp 2) and the full frame on every rank equals `render`'s, as
    tests/multiproc_worker.py holds JAX's."""
    for r in groups["futs"]["four"].result(600):
        assert r["pod"]["shape"] == {"dp": 2, "sp": 2}
        assert r["pod"]["max_diff"] == 0.0


def test_fit_mesh_equals_fit(groups, tmp_path):
    """On the (1, 1) mesh `fit` is `fit()` bit for bit; on (2, 2) (rank 0
    writes the checkpoint) within rtol 1e-4, and the sharded run's
    checkpoint resumes unsharded onto the unsharded trajectory."""
    scene, cam = tt.dist_scene_camera(False)
    ref = tt.dist_fit(scene, cam, 3)
    one = tt.dist_fit(scene, cam, 3, mesh=sharding.make_ray_mesh(1, 1))
    assert [h["loss"] for h in one] == [h["loss"] for h in ref]
    assert [h["grad_norm"] for h in one] == [h["grad_norm"] for h in ref]
    for r in groups["futs"]["four"].result(600):
        for got, want in zip(r["fit"], ref[:2]):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-4)
    resumed = tt.dist_fit(scene, cam, 3, ckpt_dir=groups["ckpt"])
    assert [h["step"] for h in resumed] == [3]
    np.testing.assert_allclose(resumed[0]["loss"], ref[2]["loss"], rtol=1e-4)
    leaves = TT.split_params(scene, cam, list(tt.DIST_TRAINABLE))
    with np.load(f"{groups['ckpt']}/train.npz") as z:
        assert int(z["step"]) == 3
        got = [z[f"leaf_{i}"] for i in range(len(leaves))]
    _, _, _ = TT.fit(scene, cam, tt.dist_config(),
                     np.zeros((H, W, 3), np.float32),
                     list(tt.DIST_TRAINABLE), 3, lr=1e-2, nsamples=2,
                     seed=0, ckpt_dir=str(tmp_path))
    with np.load(tmp_path / "train.npz") as z:
        for i, g in enumerate(got):
            np.testing.assert_allclose(g, z[f"leaf_{i}"], rtol=1e-4,
                                       atol=1e-6)


def test_dryrun_multichip_cpu(groups):
    res = groups["futs"]["dryrun"].result(600)
    assert res["mesh"] == {"dp": 1, "sp": 2}
    assert np.isfinite(res["loss"]) and res["loss"] > 0
    assert np.isfinite(res["sph_center"]).all()
