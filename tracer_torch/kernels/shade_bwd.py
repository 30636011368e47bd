"""Bounce-adjoint kernel: one bounce of the hand-written record-replay
backward (forward recompute + cotangent chains) in one pass over the lanes.

Replaces the TPU kernel `tracer/kernels/shade_bwd.py::bounce_bwd_tiles`
(Pallas, `pl.pallas_call` at shade_bwd.py:157) with the CUDA kernel
`csrc/bounce_bwd.cu`, one thread per lane. The TPU path fed the kernel
per-lane material/sphere/quad rows fetched with one-hot matmuls in XLA
(`replay_bwd.py:557-566`); the CUDA kernel reads them by index from the
small tables of `bwd_tables`. `bounce_bwd_plain` is the plain PyTorch
version: the same row fetch by index, then
`tracer_torch/render/replay_bwd.py::bounce_bwd`, the JAX package's
expressions in the same order.

What bounds it on an H100: memory traffic. An active lane reads at most
132 B (st10, j, recf, key, time, gcar) and every lane writes 248 B (a, b,
c): at most ~155 MB per 408,000-lane launch. The few hundred flops per
lane are far below the compute bound. The design reads each input once,
only where the result needs it, keeps the chain in registers and writes
each output once; lanes that are not active read only their flag and the
next-state cotangents and exit early with the pass-through.

Stacked I/O (as the TPU kernel's, `tracer/kernels/shade_bwd.py:12-21`):
  st10 [10, N]: o(3), d(3), throughput(3), active
  recf [8, N]:  img(3), raw nm(3), present masks ptex, pnm
  gcar [12, N]: go2(3), gd2(3), gtp2(3), gpix(3)
  out a [11, N]: go(3), gd(3), gtp(3), gtm, gdark
  out b [6, N]:  gimg(3), grnm(3)
  out c [45, N]: gmrf(18), gsrow(8), gqrow(19)
"""

from __future__ import annotations

import ctypes

import torch

from tracer_torch.core import rng
from tracer_torch.kernels import common as kc

LAUNCHES = 0  # launches of the CUDA kernel (not of the plain version)
MAT_COLS = 21


@torch.no_grad()
def bwd_tables(scene):
    """The small tables the adjoint reads by index:
    sph [S, 8]: center(3), radius, mb(3) (the material's motion blur),
      material id;
    quad [Q, 19]: v0(3), er(3), eu(3), mb(3), tan(3), bitan(3), material id;
    mat [M, 21]: the JAX package's matf columns (texscale(2), check1(3),
      check2(3), diffuse(3), light_color(3), light_intensity, emissive,
      transparency, ior), then textype, mtype and mat_nm as f32 (exact)."""
    def f(a):
        return a.to(torch.float32)[:, None]

    sph = torch.cat([scene.sph_center, scene.sph_radius[:, None],
                     scene.mat_mb[scene.sph_mat], f(scene.sph_mat)], dim=1)
    quad = torch.cat([scene.quad_v0, scene.quad_er, scene.quad_eu,
                      scene.mat_mb[scene.quad_mat], scene.quad_tan,
                      scene.quad_bitan, f(scene.quad_mat)], dim=1)
    mat = torch.cat([
        scene.mat_texscale, scene.mat_check1, scene.mat_check2,
        scene.mat_diffuse, scene.mat_light_color,
        scene.mat_light_intensity[:, None], scene.mat_emissive[:, None],
        scene.mat_transparency[:, None], scene.mat_ior[:, None],
        f(scene.mat_textype), f(scene.mat_type), f(scene.mat_nm)], dim=1)
    return sph.contiguous(), quad.contiguous(), mat.contiguous()


def row_ids(j_enc, sph, quad):
    """(js, jq, mid) as int64 [N]: the sphere row, quad row and material
    row a lane's adjoint reads (a miss reads sphere row 0)."""
    S, Q = sph.shape[0], quad.shape[0]
    j = torch.clamp_min(j_enc, 0).long()
    js = torch.clamp(j, 0, S - 1)
    jq = torch.clamp(j - S, 0, Q - 1)
    mid = torch.where(j < S, sph[js, 7], quad[jq, 18]).long()
    return js, jq, mid


def bounce_bwd_tiles(st10, j_enc, recf, tables, bk, tm, gcar, n_rem, dark,
                     *, S, Q, ref, eps, has_pair, last, kernels="auto"):
    """One bounce's adjoint over stacked planar inputs (module docstring).
    j_enc [N] int32 (-1 = miss); bk [N] this bounce's keys (int64 holding
    uint32); tm [N] ray time; tables: `bwd_tables(scene)`; n_rem, dark:
    floats. Returns the stacked (a [11, N], b [6, N], c [45, N])."""
    if S < 1 or Q < 1:
        raise ValueError("bounce_bwd: the scene tables need at least one "
                         "sphere row and one quad row (compile_scene pads)")
    args = (st10, j_enc, recf, tables, bk, tm, gcar, float(n_rem),
            float(dark), S, Q, bool(ref), float(eps), bool(has_pair),
            bool(last))
    if kc.use_kernel(kernels, st10):
        return _bounce_bwd_cuda(*args)
    return bounce_bwd_plain(*args)


def bounce_bwd_plain(st10, j_enc, recf, tables, bk, tm, gcar, n_rem, dark,
                     S, Q, ref, eps, has_pair, last):
    """The plain PyTorch version of the kernel."""
    from tracer_torch.render import replay_bwd as rb

    sph, quad, mat = tables
    js, jq, mid = row_ids(j_enc, sph, quad)
    srow = sph[js].t()
    qrow = quad[jq].t()
    mr = mat[torch.clamp(mid, 0, mat.shape[0] - 1)].t()

    def p3(x, r):
        return (x[r], x[r + 1], x[r + 2])

    (go, gd, gtp, gtm, gimg, grnm, gmrf, gsr, gqr, gdark) = rb.bounce_bwd(
        p3(st10, 0), p3(st10, 3), p3(st10, 6), st10[9] > 0.5, tm, bk,
        j_enc, p3(recf, 0), p3(recf, 3), recf[6], recf[7],
        [mr[c] for c in range(18)], mr[18].to(torch.int32),
        mr[19].to(torch.int32), mr[20].to(torch.int32),
        [srow[c] for c in range(8)], [qrow[c] for c in range(19)],
        p3(gcar, 0), p3(gcar, 3), p3(gcar, 6), p3(gcar, 9),
        S=S, Q=Q, ref=ref, eps=eps, n_rem=n_rem, dark=dark,
        has_pair=has_pair, last=last)
    return (torch.stack([*go, *gd, *gtp, gtm, gdark]),
            torch.stack([*gimg, *grnm]), torch.stack([*gmrf, *gsr, *gqr]))


_IO_FIELDS = ("st10", "j", "recf", "key", "tm", "gcar", "sph", "quad", "mat",
              "a", "b", "c")


class _IO(ctypes.Structure):
    """Mirror of `BwdIO` in csrc/bounce_bwd.cu (same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in _IO_FIELDS]


class _Params(ctypes.Structure):
    """Mirror of `BwdParams` in csrc/bounce_bwd.cu (same order)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "S", "Q", "M", "ref", "has_pair", "last")] + [
        (name, ctypes.c_float) for name in ("eps", "n_rem", "dark")]


def _bounce_bwd_cuda(st10, j_enc, recf, tables, bk, tm, gcar, n_rem, dark,
                     S, Q, ref, eps, has_pair, last):
    from tracer_torch.kernels import _build
    global LAUNCHES
    sph, quad, mat = tables
    dev, N = st10.device, st10.shape[1]
    f32, i32 = torch.float32, torch.int32
    M = mat.shape[0]
    io = _IO()
    io.st10 = kc.check("st10", st10, f32, (10, N), dev)
    io.j = kc.check("j", j_enc, i32, (N,), dev)
    io.recf = kc.check("recf", recf, f32, (8, N), dev)
    keys32 = rng.as_int32_bits(bk)
    io.key = kc.check("keys", keys32, i32, (N,), dev)
    io.tm = kc.check("time", tm, f32, (N,), dev)
    io.gcar = kc.check("gcar", gcar, f32, (12, N), dev)
    io.sph = kc.check("sph", sph, f32, (S, 8), dev)
    io.quad = kc.check("quad", quad, f32, (Q, 19), dev)
    io.mat = kc.check("mat", mat, f32, (M, MAT_COLS), dev)
    a = torch.empty((11, N), dtype=f32, device=dev)
    b = torch.empty((6, N), dtype=f32, device=dev)
    c = torch.empty((45, N), dtype=f32, device=dev)
    io.a, io.b, io.c = a.data_ptr(), b.data_ptr(), c.data_ptr()
    prm = _Params(n=N, S=S, Q=Q, M=M, ref=int(ref), has_pair=int(has_pair),
                  last=int(last), eps=eps, n_rem=n_rem, dark=dark)
    if N > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().tt_bounce_bwd(
            ctypes.addressof(io), ctypes.addressof(prm), stream)
        kc.raise_on_error("bounce_bwd", err)
        LAUNCHES += 1
    return a, b, c
