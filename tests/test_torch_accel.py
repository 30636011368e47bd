"""The port's BVH builders against the JAX package's: the numpy
median-split builder and the native binned-SAH builder (each package
builds its own copy of the C++ source with g++) give the same flattened
arrays on the same triangle boxes, and `compile_scene` gives the same
mesh fields with either builder."""

import time

import numpy as np
import pytest

from tracer.accel import bvh as jbvh
from tracer.accel import native as jnative
from tracer_torch.accel import bvh as tbvh
from tracer_torch.accel import native as tnative
from tracer_torch.testing import standin_mesh

FIELDS = ("node_lo", "node_hi", "node_leaf_start", "node_skip", "leaf_tris")


def load_jax_native():
    """Load the JAX package's native builder. Its loader runs `make` in
    place at first use, so another test process may be building the
    library at this moment: a failed load is retried."""
    for _ in range(30):
        if jnative._load() is not None:
            return
        jnative._TRIED = False
        time.sleep(1.0)
    pytest.fail("the JAX package's native BVH builder does not load")


def _bounds(n_tris, seed):
    verts, tris, _ = standin_mesh(n_tris, seed)
    return tbvh.triangle_bounds(verts, tris), jbvh.triangle_bounds(verts, tris)


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.n_nodes, a.leaf_width) == (b.n_nodes, b.leaf_width)


def test_triangle_bounds_match():
    (tlo, thi), (jlo, jhi) = _bounds(600, 0)
    np.testing.assert_array_equal(tlo, jlo)
    np.testing.assert_array_equal(thi, jhi)
    assert tbvh.TRIANGLE_SCALING == jbvh.TRIANGLE_SCALING


@pytest.mark.parametrize("leaf_width", [4, 16])
def test_numpy_builder_matches(leaf_width):
    (lo, hi), _ = _bounds(1500, 1)
    _same(tbvh.build_bvh(lo, hi, leaf_width, 64, sentinel=-1),
          jbvh.build_bvh(lo, hi, leaf_width, 64, sentinel=-1))


@pytest.mark.parametrize("leaf_width", [4, 16])
def test_native_builder_matches(leaf_width):
    (lo, hi), _ = _bounds(11_100, 2)
    load_jax_native()
    want = jnative.build_bvh_native(lo, hi, leaf_width, 64)
    got = tnative.build_bvh_native(lo, hi, leaf_width, 64)
    _same(got, want)
    # an SAH tree is not the median-split one
    med = tbvh.build_bvh(lo, hi, leaf_width, 64, sentinel=-1)
    assert got.n_nodes != med.n_nodes or not np.array_equal(
        got.leaf_tris, med.leaf_tris)


def test_depth_cap_chains_leaves():
    """At the depth cap an over-full leaf spills into a chain of full-width
    leaves sharing one box (both builders, both packages)."""
    (lo, hi), _ = _bounds(400, 3)
    load_jax_native()
    t = tbvh.build_bvh(lo, hi, 4, 2, sentinel=-1)
    _same(t, jbvh.build_bvh(lo, hi, 4, 2, sentinel=-1))
    _same(tnative.build_bvh_native(lo, hi, 4, 2),
          jnative.build_bvh_native(lo, hi, 4, 2))
    leaves = t.node_leaf_start >= 0
    assert leaves.sum() > 4 and (t.leaf_tris.size == 4 * leaves.sum())


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build raises instead of falling back to numpy."""
    bad = tmp_path / "bvh_builder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.library()
