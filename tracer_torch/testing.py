"""Test scenes for the parity tests and the chip smoke run (not a render
feature): a Cornell box whose image textures and normal maps are seeded
uint8 arrays instead of the reference's PPM assets, procedural
stand-in meshes in place of the reference's OFF meshes, seeded skyboxes
and sphere textures (`fill_sky`, `rt_weekend_standin`,
`raccoon_standin`), scenes past the kernels' table and mesh-count
limits (`tiled_wall`, `mesh_grid`), and a film's sum with every case the
frame's finish meets (`finish_film`).

The Cornell builder loads two textures (brick, sand) and three normal maps
(brick, floor, water — the last unused). `fill_cornell_textures` fills those
slots so that the brick walls get MATCHED texture/normal-map dims (a plain
pair-atlas region) and the floor gets MISMATCHED dims (a product region).
It takes any object with `textures` / `normal_maps` lists, so the same
arrays can be put into a `tracer` and a `tracer_torch` SceneBuilder.
"""

from __future__ import annotations

import importlib

import numpy as np

# (H, W) of each slot: brick texture and brick normal map match; the sand
# texture and the floor normal map do not
SMALL = dict(brick=(40, 56), sand=(64, 48), floor_nm=(24, 36),
             water_nm=(8, 8))
FULL = dict(brick=(1024, 1024), sand=(1024, 1024), floor_nm=(512, 512),
            water_nm=(512, 512))


def fill_cornell_textures(sb, dims=SMALL, seed: int = 0):
    """Fill a `setup_cornell_box` builder's texture and normal-map slots
    with seeded uint8 images of the given (H, W) dims; returns `sb`."""
    rs = np.random.RandomState(seed)

    def img(hw):
        return rs.randint(0, 256, size=hw + (3,), dtype=np.uint8)

    sb.textures[0] = img(dims["brick"])      # brick texture
    sb.textures[1] = img(dims["sand"])       # sand texture
    sb.normal_maps[0] = img(dims["brick"])   # brick normal map (matched)
    sb.normal_maps[1] = img(dims["floor_nm"])  # floor normal map (product)
    sb.normal_maps[2] = img(dims["water_nm"])  # loaded, unused
    return sb


# Where the zoo places the meshes the stand-ins replace: (scale, rotations
# in degrees about x, y, z, translation), applied in that order. The
# stand-in's ring lies in its local yz-plane, so the flamingo's rotations
# turn it to face the camera; the pond's extra turn about z lays it flat.
PLACEMENTS = dict(
    flamingo=(2.5, (90, 90, 180), (0., 1., -8.)),        # zoo.py:315-316
    pond=(3.0, (0, 0, 90), (1., -5., -3.)),              # zoo.py:380
    pond_flamingo=(0.8, (90, 115, 180), (3., -1.2, -1.)),  # zoo.py:389-390
    raccoon=(2.0, (0, -90, 0), (0., -2., -5.)),          # zoo.py:347
)

# (H, W) of the seeded skybox and sphere textures: the sizes of the
# reference's sky.ppm (2:1 equirect) and sphere textures
SKY_HW = (1024, 2048)
SPHERE_TEX_HW = (512, 1024)


def seeded_image(hw, seed: int = 0):
    """A seeded uint8 image [H, W, 3]: smooth colour waves plus noise, so
    that neighbouring texels differ and a texel index error shows."""
    rs = np.random.RandomState(seed)
    y, x = np.meshgrid(np.linspace(0, 1, hw[0]), np.linspace(0, 1, hw[1]),
                       indexing="ij")
    ch = [0.5 + 0.35 * np.sin(2 * np.pi * (rs.randint(1, 5) * x
                                          + rs.randint(1, 4) * y
                                          + rs.uniform()))
          for _ in range(3)]
    img = np.stack(ch, -1) + rs.uniform(-0.1, 0.1, hw + (3,))
    return (255.0 * np.clip(img, 0.0, 1.0)).astype(np.uint8)


def finish_film(n: int, seed: int = 0) -> np.ndarray:
    """A film's sum [n, 3] f32 with every case the finish meets: zeros of
    both signs, negatives, values above the clamp, infinities, NaN, tiny
    and denormal values, then seeded positive values spread over 40
    decades."""
    special = np.array([0.0, -0.0, -1.0, -1e-30, 1.0, 20.0, 21.0, 1e30,
                        np.inf, -np.inf, np.nan, -np.nan, 1e-38, 1e-45,
                        3e-39, 0.5], np.float32)
    rs = np.random.RandomState(seed)
    spread = np.concatenate([
        rs.uniform(0.0, 40.0, 3 * n),
        np.exp(rs.uniform(np.log(1e-40), np.log(40.0), 3 * n))])
    x = np.concatenate([special, rs.permutation(spread).astype(np.float32)])
    return x[:3 * n].reshape(n, 3)


def fill_sky(sb, hw=SKY_HW, seed: int = 0):
    """Give a scene builder of either package a seeded equirect skybox of
    (H, W) `hw` in place of the one its zoo builder failed to load (or in
    addition, for a builder without one); returns `sb`."""
    sb.skybox = seeded_image(hw, seed)
    return sb


def fill_assets(sb, sky: bool, sky_hw=SKY_HW, tex_hw=SPHERE_TEX_HW,
                seed: int = 0):
    """Fill every texture and normal-map slot a zoo builder (of either
    package) failed to load with a seeded image of (H, W) `tex_hw`, and,
    with `sky`, its sky slot (`fill_sky`); returns `sb`."""
    if sky:
        fill_sky(sb, sky_hw, seed)
    for k, slots in enumerate((sb.textures, sb.normal_maps)):
        for i, img in enumerate(slots):
            if img is None:
                slots[i] = seeded_image(tex_hw, seed + 100 * k + i + 1)
    return sb


def rt_weekend_standin(zoo, sky_hw=SKY_HW, tex_hw=SPHERE_TEX_HW,
                       seed: int = 0):
    """`zoo.setup_rt_in_a_weekend()` (of either package's zoo module) with
    a seeded sky and a seeded sun texture: 3 lights, a glass, a mirror and
    an emissive sphere textured by image (TEX_IMAGE: the sphere-UV index
    and the last bounce's texels), the checker floor."""
    sb = fill_sky(zoo.setup_rt_in_a_weekend(), sky_hw, seed)
    sb.textures[0] = seeded_image(tex_hw, seed + 1)
    return sb


def raccoon_standin(zoo, sky_hw=SKY_HW, tex_hw=SPHERE_TEX_HW,
                    n_tris: int = 5_000, seed: int = 0):
    """`zoo.setup_raccoon()` with a seeded sky, its three sphere textures
    seeded and a stand-in mesh at the raccoon's place."""
    sb = fill_sky(zoo.setup_raccoon(), sky_hw, seed)
    for k in range(3):
        sb.textures[k] = seeded_image(tex_hw, seed + 1 + k)
    add_standin(sb, n_tris, seed, "raccoon")
    return sb


def standin_mesh(n_tris: int = 52_900, seed: int = 0):
    """A procedural mesh of about `n_tris` triangles: a torus about the x
    axis, a grid of nu rings of 2*nu quads (2 * 2*nu^2 triangles; 52,900 for nu = 115, the
    size of the reference's flamingo.off) whose minor radius is displaced
    by seeded low-frequency waves, with seeded smooth vertex colors.
    Returns numpy (verts [V, 3] f32, tris [T, 3] i32, colors [V, 3] f32)."""
    rs = np.random.RandomState(seed)
    nu = max(3, int(round(np.sqrt(n_tris / 4.0))))
    nv = 2 * nu
    u = 2.0 * np.pi * np.arange(nu) / nu        # around the tube
    v = 2.0 * np.pi * np.arange(nv) / nv        # around the ring
    U, V = np.meshgrid(u, v, indexing="ij")     # [nu, nv]
    bump = np.zeros_like(U)
    for _ in range(4):
        ku, kv = rs.randint(1, 6), rs.randint(1, 9)
        bump += rs.uniform(0.02, 0.06) * np.sin(ku * U + kv * V
                                                + rs.uniform(0, 2 * np.pi))
    R, r = 0.45, 0.15 * (1.0 + bump)
    verts = np.stack([r * np.sin(U),
                      (R + r * np.cos(U)) * np.cos(V),
                      (R + r * np.cos(U)) * np.sin(V)], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    # wound so that the normals point out of the tube
    tris = np.concatenate([np.stack([a, c, b], -1).reshape(-1, 3),
                           np.stack([a, d, c], -1).reshape(-1, 3)])
    phase = rs.uniform(0, 2 * np.pi, 3)
    colors = 0.5 + 0.4 * np.sin(np.stack([U + phase[0], V + phase[1],
                                          U + V + phase[2]], -1))
    return (verts.astype(np.float32), tris.astype(np.int32),
            colors.reshape(-1, 3).astype(np.float32))


def add_standin(sb, n_tris: int = 52_900, seed: int = 0,
                placement: str = "flamingo"):
    """Add a `standin_mesh` to a scene builder of either package, placed
    where the zoo places the mesh it stands in for (`PLACEMENTS`), with
    the zoo's material for that mesh (zoo.py:312-313); returns the mesh."""
    mod = importlib.import_module(type(sb).__module__)
    verts, tris, colors = standin_mesh(n_tris, seed)
    m = mod.MeshObject(verts, tris, vert_colors=colors,
                       material=mod.Material(diffuse=(0.1, 0.2, 0.5),
                                             specular=(0.9, 0.9, 0.9),
                                             shininess=6.))
    scale, (rx, ry, rz), pos = PLACEMENTS[placement]
    m.scale((scale,) * 3).rotate_x(rx).rotate_y(ry).rotate_z(rz)
    m.translate(pos)
    return sb.add_mesh(m)


def flamingo_standin(zoo, n_tris: int = 52_900, seed: int = 0):
    """`zoo.setup_flamingo()` (of either package's zoo module) with a
    stand-in mesh at the flamingo's place: 2 lights, a glass and a mirror
    sphere, the checker floor and one mesh."""
    sb = zoo.setup_flamingo()
    add_standin(sb, n_tris, seed, "flamingo")
    return sb


def flamingo_pond_standin(zoo, n_pond: int = 11_100, n_flamingo: int = 52_900,
                          seed: int = 0):
    """`zoo.setup_flamingo_pond()` with stand-ins for the pond and the
    flamingo (two meshes, one light, a mirror quad)."""
    sb = zoo.setup_flamingo_pond()
    add_standin(sb, n_pond, seed, "pond")
    add_standin(sb, n_flamingo, seed + 1, "pond_flamingo")
    return sb


def tiled_wall(sb, n_quads: int, seed: int = 0):
    """Fill a scene builder of either package with a lit wall of `n_quads`
    small seeded tiles in front of the default camera, tilted and set at
    seeded depths so that scattered rays reach other tiles, plus a floor,
    a back wall, a sphere and one light: a scene whose quad tables outgrow
    shared memory (the kernels' table limits). Five materials: three diffuse, a
    mirror and a glass (two-sided). Returns `sb`."""
    mod = importlib.import_module(type(sb).__module__)
    rs = np.random.RandomState(seed)
    mats = [mod.Material(diffuse=c) for c in
            ((0.8, 0.3, 0.2), (0.2, 0.7, 0.3), (0.3, 0.4, 0.9))]
    mats.append(mod.Material(diffuse=(0.9, 0.9, 0.9), mtype=2))
    mats.append(mod.Material(diffuse=(0.8, 0.8, 1.0), mtype=1,
                             transparency=0.5, index_medium=1.5))
    sb.add_light((0., 3.5, 4.), radius=1.0, color=(1.0, 0.95, 0.9))
    sb.add_sphere((1.5, -1.0, 1.5), 0.6, mod.Material(diffuse=(0.9, 0.8, 0.2)))
    floor = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 20.,
                          20., mod.Material(diffuse=(0.6, 0.6, 0.6)))
    floor.rotate_x(-90).translate((0., -2.6, 0.))
    sb.add_square((-10., -4., -4.), (1., 0., 0.), (0., 1., 0.), 20., 12.,
                  mod.Material(diffuse=(0.7, 0.7, 0.6)))
    cols = int(np.ceil(np.sqrt(n_quads * 1.75)))
    rows = int(np.ceil(n_quads / cols))
    cw, ch = 9.0 / cols, 5.0 / rows
    for k in range(n_quads):
        r, c = divmod(k, cols)
        w, h = 0.8 * cw, 0.8 * ch
        q = sb.add_square((-w / 2, -h / 2, 0.), (1., 0., 0.), (0., 1., 0.),
                          w, h, mats[rs.randint(len(mats))])
        q.rotate_x(rs.uniform(-30., 30.)).rotate_y(rs.uniform(-30., 30.))
        q.translate((-4.5 + (c + 0.5) * cw, -2.3 + (r + 0.5) * ch,
                     -1.0 + rs.uniform(-0.6, 0.6)))
    return sb


def mesh_grid(sb, n_meshes: int, n_tris: int = 2_000, seed: int = 0):
    """Fill a scene builder of either package with `n_meshes` seeded
    `standin_mesh` tori on a grid in front of the default camera, each
    turned its own way, plus a floor and one light: a scene with more
    meshes than a fixed per-launch table of them would hold. Returns
    `sb`."""
    mod = importlib.import_module(type(sb).__module__)
    rs = np.random.RandomState(seed)
    sb.add_light((1., 4., 3.), radius=1.0, color=(1.0, 1.0, 1.0))
    floor = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 20.,
                          20., mod.Material(diffuse=(0.6, 0.6, 0.6)))
    floor.rotate_x(-90).translate((0., -2.6, 0.))
    cols = int(np.ceil(np.sqrt(n_meshes * 1.75)))
    rows = int(np.ceil(n_meshes / cols))
    for k in range(n_meshes):
        r, c = divmod(k, cols)
        verts, tris, colors = standin_mesh(n_tris, seed + k)
        m = mod.MeshObject(verts, tris, vert_colors=colors,
                           material=mod.Material(diffuse=(0.5, 0.5, 0.5)))
        m.scale((1.6,) * 3).rotate_y(rs.uniform(0., 360.))
        m.rotate_x(rs.uniform(-40., 40.))
        m.translate((-4.2 + (c + 0.5) * 8.4 / cols,
                     -2.2 + (r + 0.5) * 4.4 / rows, -1.0))
        sb.add_mesh(m)
    return sb


# ---------------------------------------------------------------------------
# Distribution (tests/test_torch_dist.py): the tiny scenes of
# tests/test_dist.py, and the body each spawned rank runs (a rank never
# imports a test module, which imports jax)
# ---------------------------------------------------------------------------

DIST_W, DIST_H = 16, 8
DIST_TRAINABLE = ("mat_diffuse", "sph_center")


def dist_builder(mod, lit: bool):
    """tests/test_dist.py's tiny scene (a light, a diffuse and a mirror
    sphere, a floor, open sky) or, without `lit`, the same without its
    light, from `mod`, the builder module of either package."""
    sb = mod.SceneBuilder()
    sb.dark_sky = False
    if lit:
        sb.add_light((-2., 4., 3.), radius=1.0)
    sb.add_sphere((0., 0., 0.), 1.0, mod.Material(diffuse=(0.8, 0.3, 0.2)))
    sb.add_sphere((1.8, 0., -1.), 0.7,
                  mod.Material(mtype=mod.MIRROR, diffuse=(0.9, 0.9, 0.9)))
    s = sb.add_square((-1., -1., 0.), (1., 0., 0.), (0., 1., 0.), 8., 8.,
                      mod.Material(diffuse=(0.3, 0.6, 0.9)))
    s.rotate_x(-90).translate((0., -1.2, 0.))
    return sb


def dist_config(**kw):
    from tracer_torch.core.config import RenderConfig
    return RenderConfig(width=DIST_W, height=DIST_H, max_bounces=3,
                        shadow_rays=2, **kw)


def dist_scene_camera(lit: bool):
    """The port's tiny scene and camera on the CPU."""
    from tracer_torch.render.camera import default_camera
    from tracer_torch.scene import builder
    from tracer_torch.scene.device import compile_scene
    return (compile_scene(dist_builder(builder, lit), device="cpu"),
            default_camera(DIST_W / DIST_H, device="cpu"))


def dist_grads(scene, camera, nsamples: int, mesh=None):
    """(image [N, 3] or this rank's block of it, {name: gradient}) of
    mean(image ** 2) over the whole image with respect to
    DIST_TRAINABLE, seed 0: unsharded (`mesh` None), or sharded with the
    gradients summed over the mesh."""
    import dataclasses

    import torch

    from tracer_torch.dist import sharding
    from tracer_torch.render.renderer import render_pixels

    cfg = dist_config()
    leaves = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in DIST_TRAINABLE}
    s = dataclasses.replace(scene, **leaves)
    pids = torch.arange(DIST_W * DIST_H, dtype=torch.int32)
    if mesh is None:
        img = render_pixels(s, camera, cfg, DIST_W, DIST_H, pids, nsamples,
                            0) / nsamples
        torch.mean(img ** 2).backward()
    else:
        img = sharding.render_pixels_sharded(s, camera, cfg, DIST_W, DIST_H,
                                             pids, nsamples, 0, mesh)
        (torch.mean(img ** 2) / mesh.shape["dp"]).backward()
        sharding.all_reduce_grads(mesh, list(leaves.values()))
    return (img.detach().numpy(),
            {k: v.grad.numpy() for k, v in leaves.items()})


def dist_fit(scene, camera, steps: int, ckpt_dir=None, mesh=None):
    """`train.fit` of DIST_TRAINABLE towards a black image, 2 spp, lr
    1e-2, from the scene's own parameters: (history, {name: value})."""
    import numpy as np

    from tracer_torch import train

    _, _, hist = train.fit(
        scene, camera, dist_config(),
        np.zeros((DIST_H, DIST_W, 3), np.float32), list(DIST_TRAINABLE),
        steps, lr=1e-2, nsamples=2, seed=0, ckpt_dir=ckpt_dir, mesh=mesh)
    return hist


def dist_rank(shapes, nsamples: int, extra: bool = False, ckpt_dir=None):
    """One rank of tests/test_torch_dist.py's spawned groups. For each
    (n_dp, n_sp) in `shapes` and each tiny scene ("unlit", "lit"): this
    rank's sharded block (no grad), the film gathered over dp, the sharded
    gradients (`dist_grads`), the collectives these three ran
    (`sharding.collective_spans`), and whether nsamples + 1 samples (not split
    over sp > 1) and N - 1 pixels (not split over dp > 1) raise. With
    `extra` (the 4-rank group): `train_step` on (2, 2) from the unlit
    scene (target black, seed 1), `render_image_multihost` on
    `make_pod_mesh(n_sp=2)` (2 hosts x 2 ranks) against `render`, and
    `fit` on (2, 2) for 2 steps writing its checkpoint to `ckpt_dir`."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tracer_torch.dist import multihost, sharding
    from tracer_torch.render.renderer import render

    out = dict(rank=dist.get_rank(), meshes={})
    scenes = {k: dist_scene_camera(k == "lit") for k in ("unlit", "lit")}
    pids = torch.arange(DIST_W * DIST_H, dtype=torch.int32)
    for shape in shapes:
        mesh = sharding.make_ray_mesh(*shape)
        res = dict(coord=(mesh.dp_rank, mesh.sp_rank))
        for name, (scene, cam) in scenes.items():
            with sharding.collective_spans() as spans:
                with torch.no_grad():
                    blk = sharding.render_pixels_sharded(
                        scene, cam, dist_config(), DIST_W, DIST_H, pids,
                        nsamples, 0, mesh)
                film = multihost.gather_film(blk, mesh).cpu().numpy()
                _, grads = dist_grads(scene, cam, nsamples, mesh)
            res[name] = dict(block=blk.numpy(), film=film, grads=grads,
                             spans=spans)
        raises = []
        for n_pix, ns in ((DIST_W * DIST_H - 1, nsamples),
                          (DIST_W * DIST_H, nsamples + 1)):
            try:
                sharding.render_pixels_sharded(
                    *scenes["unlit"], dist_config(), DIST_W, DIST_H,
                    pids[:n_pix], ns, 0, mesh)
                raises.append(False)
            except ValueError:
                raises.append(True)
        res["raises"] = raises
        out["meshes"][shape] = res
    if extra:
        scene, cam = scenes["unlit"]
        mesh = sharding.make_ray_mesh(2, 2)
        loss, s1, c1 = sharding.train_step(
            scene, cam, dist_config(), DIST_W, DIST_H, pids,
            torch.zeros((DIST_W * DIST_H, 3)), nsamples, 1, mesh)
        out["train_step"] = dict(
            loss=float(loss), cam_position=c1.position.numpy(),
            **{k: getattr(s1, k).numpy()
               for k in ("sph_center", "sph_radius", "mat_diffuse",
                         "tex_data", "mesh_verts")})
        pod = multihost.make_pod_mesh(n_sp=2)
        scene, cam = scenes["lit"]
        cfg = dist_config(nsamples=2)
        img = multihost.render_image_multihost(scene, cam, cfg, pod)
        out["pod"] = dict(shape=dict(pod.shape),
                          max_diff=float(np.abs(
                              img - render(scene, cam, cfg)).max()))
        out["fit"] = dist_fit(*scenes["unlit"], 2, ckpt_dir, mesh)
    return out


def multihost_rank():
    """One rank of tests/test_torch_bench_multihost.py's group: its
    coordinate on `multihost.make_pod_mesh()`, the sum of its block of the
    harness's frame (`bench_multihost.frame`) and `measure`'s result."""
    from tracer_torch import bench_multihost
    from tracer_torch.dist import multihost

    mesh = multihost.make_pod_mesh()
    run, n = bench_multihost.frame(mesh, device="cpu")
    return dict(coord=(mesh.dp_rank, mesh.sp_rank),
                shape=(mesh.shape["dp"], mesh.shape["sp"]), n=n, sum=run(),
                measured=bench_multihost.measure(mesh, "test", device="cpu"))
