"""BVH walk kernel: the closest triangle hit (t, tri) of every ray in every
mesh, by a stackless skip-link walk of each mesh's flattened BVH.

Replaces the TPU kernel `tracer/kernels/traverse.py::mesh_closest_hits`
(Pallas, `pl.pallas_call` at traverse.py:238) with the CUDA kernel
`csrc/traverse.cu`. The TPU kernel walks a packet of 32x128 rays through
one preorder to amortise scalar control flow; here each (ray, mesh) is a
work item that one thread walks alone (the walk of
`primitives.bvh_closest_hit`), in two CUDA kernels per call: a pass that
tests every item against its mesh's root box and ends the misses, then
one wave of persistent blocks whose lanes take the next remaining item
from a work counter when their walk ends, so the few long walks do not
hold whole warps and waves. `mesh_closest_hits_plain` is the plain
PyTorch version: the same walk in lockstep over all lanes, with the same
expressions in the same order.

What bounds it on an H100: the longest walks' chains of dependent L2
loads, not the bytes. A ray reads 28 B and writes 8 B per mesh; the tree
(53k triangles at leaf width 16: ~7 MB of leaf rows, ~0.4 MB of nodes)
stays in the 50 MB L2, and every node visit costs a load round, a slab
test and, at a leaf, one load round per triangle slot. The plain version
counts visits and tests per ray into its `stats`.

Semantics (mirrored from the TPU kernel and `bvh_closest_hit`):
- the slab test is min(best t, tfar) > max(0, tnear) with 1/d hoisted; min
  and max propagate a NaN (an axis-parallel ray), which fails the test;
- the per-triangle constants come from the leaf table
  (`traverse_tables`), in the order of traverse.py:140-170;
- within a leaf strict-< keeps the first minimum;
- lanes with `live` false return (INF, -1);
- any number of meshes: their node ranges reach the kernel as a device
  array (`mesh_ranges`); each block keeps the first `ROOT_CACHE` root
  nodes in shared memory and reads the others through the read-only
  cache.
"""

from __future__ import annotations

import ctypes

import torch

from tracer_torch.geometry import primitives as prim
from tracer_torch.kernels import common as kc

TRI_COLS = 32     # padded per-triangle slot in a leaf row
LAUNCHES = 0      # launches of the CUDA kernel (not of the plain version)
ROOT_CACHE = 16   # root nodes a block keeps in shared memory (csrc/bvh.cuh)
_RANGES = {}      # (device, mesh_root, mesh_end) -> mesh_ranges' tensor


def traverse_tables(scene):
    """(nodes_f [Bn, 8] f32, nodes_i [Bn, 2] i32, leaf [NL, LW*32] f32),
    the TPU kernel's tables (`tracer/kernels/traverse.py::traverse_tables`)
    with one spare column filled.

    nodes_f: lo(3), hi(3), the leaf's count of real (non-padding)
    triangles (0 at an inner node; a zero column in the TPU table), 0;
    nodes_i: leaf row (-1 at an inner node), skip. Leaf row slot s (cols
    s*32+c): 0:3 a, 3:6 n, 6 D, 7:10 v0, 10:13 v1, 13 d00, 14 d01, 15 d11,
    16 denom_safe, 17 tid (f32), zeros to 32; the padding slots (the
    sentinel triangle) come last."""
    LW = scene.leaf_width
    a = tuple(scene.tri_a.T)
    b = tuple(scene.tri_b.T)
    c = tuple(scene.tri_c.T)
    n, D, v0, v1, d00, d01, d11, den = prim.triangle_consts(a, b, c)
    T1 = scene.tri_a.shape[0]
    tidf = torch.arange(T1, dtype=torch.float32, device=scene.device)
    pre = torch.stack([*a, *n, D, *v0, *v1, d00, d01, d11, den, tidf], dim=1)
    pre = torch.nn.functional.pad(pre, (0, TRI_COLS - pre.shape[1]))
    leaf = pre[scene.bvh_leaf_tris.long()]
    leaf = leaf.reshape(leaf.shape[0] // LW, LW * TRI_COLS)
    Bn = scene.bvh_lo.shape[0]
    ls = scene.bvh_leaf_start
    leaf_row = torch.where(ls >= 0, torch.div(ls, LW, rounding_mode="floor"),
                           -1)
    real = (scene.bvh_leaf_tris.reshape(-1, LW) != T1 - 1).sum(1)
    count = torch.where(ls >= 0, real[leaf_row.clamp_min(0).long()], 0)
    nodes_f = torch.cat([scene.bvh_lo, scene.bvh_hi,
                         count.to(torch.float32)[:, None],
                         torch.zeros((Bn, 1), dtype=torch.float32,
                                     device=scene.device)], dim=1)
    nodes_i = torch.stack([leaf_row, scene.bvh_skip], dim=1).to(torch.int32)
    return nodes_f.contiguous(), nodes_i.contiguous(), leaf.contiguous()


def mesh_closest_hits(scene, o, d, live=None, kernels="auto", tables=None):
    """Closest raw mesh hits for planar rays o, d ([N] f32 each): (t
    [Nm, N] f32, tri [Nm, N] int32), INF / -1 on a miss or a lane with
    `live` [N] bool false. `tables`: a precomputed `traverse_tables`."""
    if tables is None:
        tables = traverse_tables(scene)
    if live is None:
        live = torch.ones_like(o[0], dtype=torch.bool)
    if kc.use_kernel(kernels, o[0]):
        return _mesh_closest_hits_cuda(scene, o, d, live, tables)
    return mesh_closest_hits_plain(scene, o, d, live, tables)


def _leaf_tester(scene, tables, o, d):
    """The leaf test of the kernel for `primitives.skip_walk`: the
    triangles of the leaf rows `rows` against the rays of `lanes`, from the
    leaf table's constants (same expressions as `triangle_test`)."""
    _, _, leaf = tables
    LW = scene.leaf_width
    sentinel = scene.tri_a.shape[0] - 1

    def test(lanes, rows):
        r = leaf[rows].reshape(-1, LW, TRI_COLS)
        col = [r[:, :, k] for k in range(18)]
        oo = tuple(x[lanes][:, None] for x in o)
        dd = tuple(x[lanes][:, None] for x in d)
        t, ok = prim.triangle_test_consts(
            oo, dd, tuple(col[0:3]), tuple(col[3:6]), col[6],
            tuple(col[7:10]), tuple(col[10:13]), col[13], col[14], col[15],
            col[16])
        tids = col[17].to(torch.int32)
        return (*prim.leaf_first_min(t, ok, tids), (tids != sentinel).sum(1))

    return test


def mesh_walk_plain(scene, o, d, m, live, tables, stats=None, tmax=None,
                    lane_counts=None):
    """Mesh m's closest raw hits (t [N], tri [N] int32) by the skip-link
    walk of all lanes in lockstep (`primitives.skip_walk`) with the
    kernel's leaf test; INF / -1 where `live` is false. `stats`, `tmax`
    and `lane_counts`: as in `skip_walk`."""
    nodes_f, nodes_i, _ = tables
    return prim.skip_walk(o, d, nodes_f[:, 0:3], nodes_f[:, 3:6],
                          nodes_i[:, 0], nodes_i[:, 1], scene.mesh_root[m],
                          scene.mesh_end[m], _leaf_tester(scene, tables, o, d),
                          live, stats, tmax, lane_counts)


def mesh_closest_hits_plain(scene, o, d, live, tables, stats=None):
    """The plain PyTorch version: `mesh_walk_plain` for every mesh.
    `stats`, a dict, gains the node visits and real triangle tests, and
    "lane_counts": [2, live rays] int64, each live ray's node visits and
    real triangle tests summed over the meshes."""
    N, dev = o[0].shape[0], o[0].device
    counts = (torch.zeros((2, N), dtype=torch.int64, device=dev)
              if stats is not None else None)
    ts, tris = [], []
    for m in range(len(scene.mesh_root)):
        t, tri = mesh_walk_plain(scene, o, d, m, live, tables, stats,
                                 lane_counts=counts)
        ts.append(t)
        tris.append(tri)
    if stats is not None:
        stats["lane_counts"] = counts[:, live]
    if not ts:
        return (torch.zeros((0, N), dtype=torch.float32, device=dev),
                torch.zeros((0, N), dtype=torch.int32, device=dev))
    return torch.stack(ts), torch.stack(tris)


class _Args(ctypes.Structure):
    """Mirror of `TraverseArgs` in csrc/traverse.cu (same order)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "ox", "oy", "oz", "dx", "dy", "dz", "live", "nodes_f", "nodes_i",
        "leaf", "out_t", "out_tri", "tasks", "work", "ranges")] + [
        (name, ctypes.c_int) for name in (
            "n", "n_meshes", "leaf_width", "blocks")]


def mesh_ranges(scene, dev):
    """[Nm, 2] int32 on `dev`: each mesh's node range (root, end) in the
    flattened BVH, made once per scene and device."""
    key = (str(dev), tuple(scene.mesh_root), tuple(scene.mesh_end))
    if key not in _RANGES:
        _RANGES[key] = torch.tensor(
            list(zip(scene.mesh_root, scene.mesh_end)),
            dtype=torch.int32, device=dev).reshape(-1, 2)
    return _RANGES[key]


def fill_tree_args(a, scene, tables, dev):
    """Check the tree tables and write them, the mesh ranges and the leaf
    width into a kernel argument struct (B5's and B6's share these
    fields)."""
    nodes_f, nodes_i, leaf = tables
    Nm = len(scene.mesh_root)
    LW = scene.leaf_width
    Bn = nodes_f.shape[0]
    a.nodes_f = kc.check("nodes_f", nodes_f, torch.float32, (Bn, 8), dev)
    a.nodes_i = kc.check("nodes_i", nodes_i, torch.int32, (Bn, 2), dev)
    a.leaf = kc.check("leaf", leaf, torch.float32,
                      (leaf.shape[0], LW * TRI_COLS), dev)
    a.ranges = mesh_ranges(scene, dev).data_ptr()
    a.n_meshes, a.leaf_width = Nm, LW


def check_items(kernel, n_items):
    """The kernels index their work items (and a work counter that runs
    past the last by at most 32 per warp) in int32."""
    if n_items > 2 ** 31 - 2 ** 24:
        raise ValueError(f"{kernel}: {n_items} work items exceed the "
                         "kernel's int32 indices")


def _mesh_closest_hits_cuda(scene, o, d, live, tables):
    from tracer_torch.kernels import _build
    global LAUNCHES
    dev = o[0].device
    N = o[0].shape[0]
    Nm = len(scene.mesh_root)
    check_items("traverse", N * Nm)
    f32 = torch.float32
    a = _Args()
    for name, t in zip(("ox", "oy", "oz"), o):
        setattr(a, name, kc.check(name, t, f32, (N,), dev))
    for name, t in zip(("dx", "dy", "dz"), d):
        setattr(a, name, kc.check(name, t, f32, (N,), dev))
    a.live = kc.check("live", live, torch.bool, (N,), dev)
    fill_tree_args(a, scene, tables, dev)
    out_t = torch.empty((Nm, N), dtype=f32, device=dev)
    out_tri = torch.empty((Nm, N), dtype=torch.int32, device=dev)
    # the rays that enter a root box (at most all of them), then the task
    # count and the walk's work counter
    tasks = torch.empty((Nm * N,), dtype=torch.int32, device=dev)
    work = torch.zeros((2,), dtype=torch.int32, device=dev)
    a.out_t, a.out_tri = out_t.data_ptr(), out_tri.data_ptr()
    a.tasks, a.work = tasks.data_ptr(), work.data_ptr()
    a.n = N
    if N > 0 and Nm > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().tt_traverse(ctypes.addressof(a), stream)
        kc.raise_on_error("traverse", err)
        LAUNCHES += 1
    return out_t, out_tri
