"""Bounce-adjoint kernel: one bounce of the hand-written record-replay
backward (forward recompute + cotangent chains) in one pass over the lanes,
with the bounce's row cotangents added onto the sweep's running tables.

Replaces the TPU kernel `tracer/kernels/shade_bwd.py::bounce_bwd_tiles`
(Pallas, `pl.pallas_call` at shade_bwd.py:157) and the one-hot matmuls the
JAX sweep runs around it (`tracer/render/replay_bwd.py:557-566` fetch the
rows, `:639-644` fold the row cotangents into the tables) with the CUDA
kernels of `csrc/bounce_bwd.cu`: a persistent adjoint kernel that reads
the rows by index from the small tables of `bwd_tables` and sums the row
cotangents per warp and per block, and a kernel that adds the blocks'
partial rows onto the running tables in block order. `bounce_bwd_plain`
is the plain PyTorch version: the same row fetch by index,
`tracer_torch/render/replay_bwd.py::bounce_bwd` (the JAX package's
expressions in the same order), then the one-hot accumulation
(`replay_bwd._onehot_accum`).

What bounds it on an H100: memory traffic. An active lane reads at most
128 B and every lane writes 40 B (a) and, with the pair atlas, 24 B (b):
~65-75 MB per 408,000-lane launch. The row cotangents (180 B a lane)
never leave the chip. Inside each block the active lanes run first, so no
warp issues both the adjoint and the pass-through.

Stacked I/O (as the TPU kernel's, `tracer/kernels/shade_bwd.py:12-21`):
  st10 [10, N]: o(3), d(3), throughput(3), active
  recf [8, N]:  img(3), raw nm(3), present masks ptex, pnm (None without
                the pair atlas: the record is all zero then)
  gnext [10, N]: the previous call's `a` (None on the last bounce)
  gpix [3, N]: the radiance cotangent
  acc [C]: the running tables, C = 18M + 8S + 19Q + 1 (`table_views`)
  out a [10, N]: go(3), gd(3), gtp(3), gtm (gnext's gtm plus this
                 bounce's: the running sum of the time cotangent)
  out b [6, N]:  gimg(3), grnm(3) (None without the pair atlas)
  out acc [C]:   acc plus this bounce's row and dark_sky cotangents
"""

from __future__ import annotations

import ctypes

import torch

from tracer_torch.core import rng
from tracer_torch.kernels import common as kc

LAUNCHES = 0  # calls that launched the CUDA kernels (not the plain version)
MAT_COLS = 21
WARPS = 8                    # warps per block of csrc/bounce_bwd.cu
SMEM_TABLES = 40 * 1024      # warp tables in shared memory up to this size
SCRATCH_FLOATS = 1 << 24     # global warp tables: at most 64 MB


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


def table_size(S, Q, M):
    """Entries of the running tables: gmatf, gsph, gquad and gdark."""
    return 18 * M + 8 * S + 19 * Q + 1


def table_views(acc, S, Q, M):
    """(gmatf [18, M], gsph [8, S], gquad [19, Q], gdark [1]): views of the
    flat running tables (the JAX sweep's transposed accumulators)."""
    o1, o2 = 18 * M, 18 * M + 8 * S
    return (acc[:o1].view(18, M), acc[o1:o2].view(8, S),
            acc[o2:o2 + 19 * Q].view(19, Q), acc[-1:])


def row_ids(j_enc, sph, quad):
    """(js, jq, mid) as int64 [N]: the sphere row, quad row and material
    row a lane's adjoint reads (a miss reads sphere row 0)."""
    S, Q = sph.shape[0], quad.shape[0]
    j = torch.clamp_min(j_enc, 0).long()
    js = torch.clamp(j, 0, S - 1)
    jq = torch.clamp(j - S, 0, Q - 1)
    mid = torch.where(j < S, sph[js, 7], quad[jq, 18]).long()
    return js, jq, mid


def bounce_bwd_tiles(st10, j_enc, recf, tables, bk, tm, gnext, gpix, acc,
                     n_rem, dark, *, S, Q, ref, eps, has_pair, last,
                     kernels="auto"):
    """One bounce's adjoint over stacked planar inputs (module docstring).
    j_enc [N] int32 (-1 = miss); bk [N] this bounce's keys (int64 holding
    uint32); tm [N] ray time; tables: `bwd_tables(scene)`; n_rem, dark:
    floats. Returns (a [10, N], b [6, N] or None, acc [C]); `acc` itself
    is not changed."""
    if S < 1 or Q < 1:
        raise ValueError("bounce_bwd: the scene tables need at least one "
                         "sphere row and one quad row (compile_scene pads)")
    if (gnext is None) != bool(last):
        raise ValueError("bounce_bwd: gnext is None exactly on the last "
                         "bounce")
    args = (st10, j_enc, recf if has_pair else None, tables, bk, tm, gnext,
            gpix, acc, float(n_rem), float(dark), S, Q, bool(ref),
            float(eps), bool(has_pair), bool(last))
    if kc.use_kernel(kernels, st10):
        return _bounce_bwd_cuda(*args)
    return bounce_bwd_plain(*args)


def bounce_bwd_plain(st10, j_enc, recf, tables, bk, tm, gnext, gpix, acc,
                     n_rem, dark, S, Q, ref, eps, has_pair, last):
    """The plain PyTorch version of the kernels: the lane math, then the
    one-hot accumulation of the row cotangents."""
    from tracer_torch.render import replay_bwd as rb

    sph, quad, mat = tables
    M = mat.shape[0]
    N = st10.shape[1]
    js, jq, mid = row_ids(j_enc, sph, quad)
    srow = sph[js].t()
    qrow = quad[jq].t()
    mr = mat[torch.clamp(mid, 0, M - 1)].t()
    if recf is None:
        recf = torch.zeros((8, N), dtype=torch.float32, device=st10.device)
    if last:
        gnext = torch.zeros((10, N), dtype=torch.float32, device=st10.device)

    def p3(x, r):
        return (x[r], x[r + 1], x[r + 2])

    (go, gd, gtp, gtm, gimg, grnm, gmrf, gsr, gqr, gdark) = rb.bounce_bwd(
        p3(st10, 0), p3(st10, 3), p3(st10, 6), st10[9] > 0.5, tm, bk,
        j_enc, p3(recf, 0), p3(recf, 3), recf[6], recf[7],
        [mr[c] for c in range(18)], mr[18].to(torch.int32),
        mr[19].to(torch.int32), mr[20].to(torch.int32),
        [srow[c] for c in range(8)], [qrow[c] for c in range(19)],
        p3(gnext, 0), p3(gnext, 3), p3(gnext, 6), p3(gpix, 0),
        S=S, Q=Q, ref=ref, eps=eps, n_rem=n_rem, dark=dark,
        has_pair=has_pair, last=last)
    if not last:
        gtm = gnext[9] + gtm
    gmatf, gsph, gquad, gd0 = table_views(acc, S, Q, M)
    out = torch.cat([
        rb._onehot_accum(gmatf, mid, torch.stack(gmrf)).reshape(-1),
        rb._onehot_accum(gsph, js, torch.stack(gsr)).reshape(-1),
        rb._onehot_accum(gquad, jq, torch.stack(gqr)).reshape(-1),
        gd0 + torch.sum(gdark)])
    a = torch.stack([*go, *gd, *gtp, gtm])
    b = torch.stack([*gimg, *grnm]) if has_pair else None
    return a, b, out


_IO_FIELDS = ("st10", "j", "recf", "key", "tm", "gnext", "gpix", "sph",
              "quad", "mat", "acc", "a", "b", "part", "wtab", "acc_out")


class _IO(ctypes.Structure):
    """Mirror of `BwdIO` in csrc/bounce_bwd.cu (same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in _IO_FIELDS]


class _Params(ctypes.Structure):
    """Mirror of `BwdParams` in csrc/bounce_bwd.cu (same order)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "S", "Q", "M", "ref", "has_pair", "last", "smem_tables",
        "max_blocks")] + [
        (name, ctypes.c_float) for name in ("eps", "n_rem", "dark")]


def scratch_plan(C, sms):
    """(warp tables in shared memory?, most blocks): the warp tables of a
    block (WARPS x C floats) go to shared memory when they fit in
    SMEM_TABLES, else to global scratch of at most SCRATCH_FLOATS; a block
    of 256 threads can have at most 8 neighbours on an SM."""
    most = 8 * sms
    if WARPS * C * 4 <= SMEM_TABLES:
        return True, most
    return False, max(1, min(most, SCRATCH_FLOATS // (WARPS * C)))


def _bounce_bwd_cuda(st10, j_enc, recf, tables, bk, tm, gnext, gpix, acc,
                     n_rem, dark, S, Q, ref, eps, has_pair, last):
    from tracer_torch.kernels import _build
    global LAUNCHES
    sph, quad, mat = tables
    dev, N = st10.device, st10.shape[1]
    f32, i32 = torch.float32, torch.int32
    M = mat.shape[0]
    C = table_size(S, Q, M)
    io = _IO()
    io.st10 = kc.check("st10", st10, f32, (10, N), dev)
    io.j = kc.check("j", j_enc, i32, (N,), dev)
    if has_pair:
        io.recf = kc.check("recf", recf, f32, (8, N), dev)
    if not last:
        keys32 = rng.as_int32_bits(bk)
        io.key = kc.check("keys", keys32, i32, (N,), dev)
        io.gnext = kc.check("gnext", gnext, f32, (10, N), dev)
    io.tm = kc.check("time", tm, f32, (N,), dev)
    io.gpix = kc.check("gpix", gpix, f32, (3, N), dev)
    io.sph = kc.check("sph", sph, f32, (S, 8), dev)
    io.quad = kc.check("quad", quad, f32, (Q, 19), dev)
    io.mat = kc.check("mat", mat, f32, (M, MAT_COLS), dev)
    io.acc = kc.check("acc", acc, f32, (C,), dev)
    a = torch.empty((10, N), dtype=f32, device=dev)
    b = torch.empty((6, N), dtype=f32, device=dev) if has_pair else None
    acc_out = torch.empty_like(acc)
    in_smem, most = scratch_plan(
        C, torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty((most, C), dtype=f32, device=dev)
    wtab = (None if in_smem else
            torch.empty((most * WARPS * C,), dtype=f32, device=dev))
    io.a, io.part, io.acc_out = a.data_ptr(), part.data_ptr(), \
        acc_out.data_ptr()
    if b is not None:
        io.b = b.data_ptr()
    if wtab is not None:
        io.wtab = wtab.data_ptr()
    prm = _Params(n=N, S=S, Q=Q, M=M, ref=int(ref), has_pair=int(has_pair),
                  last=int(last), smem_tables=int(in_smem), max_blocks=most,
                  eps=eps, n_rem=n_rem, dark=dark)
    if N == 0:
        return a, b, acc.clone()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.library().tt_bounce_bwd(
        ctypes.addressof(io), ctypes.addressof(prm), stream)
    kc.raise_on_error("bounce_bwd", err)
    LAUNCHES += 1
    return a, b, acc_out
