"""The replay's row gathers and their deterministic row sums
(`tracer_torch/render/integrator.py::_take`, `_rows`, `_GatherRows`;
`tracer_torch/kernels/rowsum.py`) on the CPU, where the row sum is its
plain version (`index_add_`, in lane order here).

- The gradient of `_rows` equals the vjp of the JAX package's one-hot
  `_rows` (`tracer/render/integrator.py:154`, its callers' clip in front)
  to f32 summation order: rtol 1e-6, atol 1e-6 * the gradient's largest
  entry (measured: at most 7.3e-7 of it, at 12 rows of 19 columns; XLA's
  product sums in another order than `index_add_`), with the tables of 0,
  1, 12 and 3,000 rows and 3, 8 and 19 columns of the replay (`mat_mb`,
  `sph_pack`, `quad_pack`, `matf`), ids outside the table included. The
  forward is exact.
- `_take`'s gradient equals `index_select`'s own (`index_add_`) bit for
  bit, for 1-D and 2-D tables and index shapes; integer tables and tables
  that do not require grad take no Function; an empty index gives a zero
  gradient.
- The wrapper takes the plain version for CPU tensors and refuses them
  under kernels="on".
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tracer.render import integrator as jintegrator
from tracer_torch.kernels import rowsum
from tracer_torch.render import integrator

N = 3000


@pytest.mark.parametrize("C", [3, 8, 19])
@pytest.mark.parametrize("R", [0, 1, 12, 3000])
def test_rows_grad_matches_jax_onehot_vjp(R, C):
    rng = np.random.default_rng(100 * R + C)
    table = rng.standard_normal((R, C)).astype(np.float32)
    idx = rng.integers(-5, R + 5, size=N).astype(np.int32)  # some clamped
    g = rng.standard_normal((N, C)).astype(np.float32)

    t = torch.from_numpy(table).requires_grad_(True)
    out = integrator._rows(t, torch.from_numpy(idx))
    if out.requires_grad:
        out.backward(torch.from_numpy(g))
        got = t.grad.numpy()
    else:   # no rows: zero rows out, no gradient path
        assert R == 0
        got = np.zeros_like(table)

    jidx = jnp.clip(jnp.asarray(idx), 0, R - 1)
    want_out, vjp = jax.vjp(lambda tb: jintegrator._rows(tb, jidx),
                            jnp.asarray(table))
    want, = vjp(jnp.asarray(g))
    want = np.asarray(want)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(want_out))
    assert got.shape == want.shape == (R, C)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)
    # and the plain row sum is index_add_ itself
    plain = torch.zeros((R, C)).index_add_(
        0, torch.from_numpy(np.clip(idx, 0, max(R - 1, 0))).long(),
        torch.from_numpy(g)) if R else torch.zeros((0, C))
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("table_shape,idx_shape", [
    ((40, 3), (500,)),          # mesh_verts by one corner's indices
    ((7,), (20, 30)),           # a 1-D table, a 2-D index
    ((9, 2, 4), (300,)),        # rows of more than one axis
    ((5, 3), (0,)),             # no lanes
])
def test_take_grad_equals_index_select_grad(table_shape, idx_shape):
    rng = np.random.default_rng(7)
    table = rng.standard_normal(table_shape).astype(np.float32)
    idx = rng.integers(0, table_shape[0], size=idx_shape).astype(np.int64)
    g = rng.standard_normal(idx_shape + table_shape[1:]).astype(np.float32)

    t = torch.from_numpy(table).requires_grad_(True)
    out = integrator._take(t, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g))
    ref = torch.from_numpy(table).requires_grad_(True)
    want = torch.index_select(ref, 0, torch.from_numpy(idx).reshape(-1))
    want.reshape(out.shape).backward(torch.from_numpy(g))
    assert torch.equal(out.detach(), want.detach().reshape(out.shape))
    assert torch.equal(t.grad, ref.grad)
    if not idx.size:
        assert not bool(t.grad.any())


def test_take_without_grad_takes_no_function():
    """An int table (mati) and a table that does not require grad are
    plain gathers: no node of `_GatherRows` in the graph."""
    mati = torch.arange(24, dtype=torch.int32).reshape(6, 4)
    out = integrator._rows(mati, torch.tensor([0, 5, 9, -1]))
    assert out.dtype == torch.int32 and out.grad_fn is None
    assert out[:, 0].tolist() == [0, 20, 20, 0]
    leaf = torch.ones((3, 2), requires_grad=True)
    with torch.no_grad():
        assert integrator._take(leaf, torch.tensor([2, 1])).grad_fn is None
    rows = integrator._take(leaf, torch.tensor([2, 1]))
    node = rows.grad_fn.next_functions[0][0]   # under the reshape's view
    assert type(node).__name__.startswith("_GatherRows")


def test_row_sum_dispatch_on_cpu():
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 10, 100).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((100, 5)).astype(np.float32))
    before = rowsum.LAUNCHES
    got = rowsum.row_sum(idx, g, 10)
    assert torch.equal(got, rowsum.row_sum_plain(idx, g, 10))
    assert torch.equal(got, rowsum.row_sum(idx, g, 10, kernels="off"))
    assert rowsum.LAUNCHES == before
    with pytest.raises(RuntimeError, match="needs CUDA"):
        rowsum.row_sum(idx, g, 10, kernels="on")
