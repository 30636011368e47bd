"""The port's texel-cotangent fold (the plain PyTorch version of the CUDA
kernel `kernels/csrc/sorted_fold.cu`) against the JAX package's sorted
Pallas fold in interpret mode and against the flat scatter-add, on update
streams made from a numpy seed. The sums are taken in another order than
the Pallas kernel's per-window contractions, so they agree to f32
summation tolerance (rtol 1e-5, atol 1e-5 * max|x|), against both and
against a float64 scatter."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tracer.kernels import fold as jfold
from tracer_torch.kernels import fold as tfold


def flat(data, idx, g):
    """data [P, 3] + the scatter-add of g [3, M] at idx [M], in float64."""
    out = data.astype(np.float64).copy()
    for a in range(3):
        np.add.at(out[:, a], idx, g[a].astype(np.float64))
    return out


def close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def stream(P, M, seed, hot=False):
    rs = np.random.RandomState(seed)
    if hot:   # half the updates on 5 texels, the rest past two windows
        idx = np.concatenate([
            rs.randint(0, 5, M // 2),
            rs.randint(2 * jfold.W, P, M - M // 2)]).astype(np.int32)
    else:
        idx = rs.randint(0, P, M).astype(np.int32)
    g = rs.normal(size=(3, M)).astype(np.float32)
    data = rs.normal(size=(P, 3)).astype(np.float32)
    return data, idx, g


@pytest.mark.parametrize("case", ["uniform", "skewed_and_empty_windows"])
def test_fold_matches_pallas_and_flat(case):
    hot = case != "uniform"
    P, M = (3 * jfold.W + 7, 1 << 15) if hot else (20000, 1 << 17)
    data, idx, g = stream(P, M, seed=2, hot=hot)
    if hot:
        data[:] = 0.0
    got = tfold.sorted_fold(torch.from_numpy(data), torch.from_numpy(idx),
                            *(torch.from_numpy(g[a]) for a in range(3)))
    got = got.numpy()
    want = np.asarray(jfold.sorted_fold(
        jnp.asarray(data), jnp.asarray(idx), *(jnp.asarray(g[a])
                                               for a in range(3)),
        interpret=True))
    close(got, want)
    close(got, flat(data, idx, g))
    if hot:   # window 1 is untouched: exactly zero
        assert np.abs(got[jfold.W:2 * jfold.W]).max() == 0.0


def test_fold_updates_over_bounces():
    """Several bounces' updates (int index arrays of any shape, planar
    cotangents) fold as one stream, like the JAX package's fold_updates."""
    rs = np.random.RandomState(3)
    P, M, nb = 500, 1000, 3
    idxs = [rs.randint(0, P, (2, M // 2)).astype(np.int32)
            for _ in range(nb)]
    gs = [rs.normal(size=(3, 2, M // 2)).astype(np.float32)
          for _ in range(nb)]
    data = np.zeros((P, 3), np.float32)
    got = tfold.fold_updates(
        torch.from_numpy(data), [torch.from_numpy(i) for i in idxs],
        [tuple(torch.from_numpy(g[a]) for a in range(3)) for g in gs])
    want = np.asarray(jfold.fold_updates(
        jnp.asarray(data), [jnp.asarray(i) for i in idxs],
        [tuple(jnp.asarray(g[a]) for a in range(3)) for g in gs],
        use_kernel=False))
    close(got.numpy(), want)
    close(got.numpy(), flat(data, np.concatenate([i.reshape(-1)
                                                   for i in idxs]),
                            np.concatenate([g.reshape(3, -1) for g in gs],
                                           axis=1)))


@pytest.mark.parametrize("case", ["three_quarters_zero", "non_finite"])
def test_fold_contract(case):
    """What the kernel is held to on the card, on the plain version: a
    stream whose updates are 3/4 exact zeros on texel 0 (a Cornell record:
    lanes with no texel; the kernel drops them) folds as the flat float64
    scatter does, and a NaN or +-inf cotangent reaches its texel as there
    (the kernel keeps them). Several bounces' rows, as the backward
    passes them."""
    rs = np.random.RandomState(4)
    P, n, nb = 777, 4000, 3
    idxs, gs = [], []
    for _ in range(nb):
        idx = rs.randint(0, P, n).astype(np.int32)
        g = rs.normal(size=(3, n)).astype(np.float32)
        zero = rs.rand(n) < 0.75
        idx[zero] = 0
        g[:, zero] = 0.0
        g[:, zero & (rs.rand(n) < 0.5)] *= -1.0   # -0 as well as +0
        idxs.append(idx)
        gs.append(g)
    if case == "non_finite":
        gs[0][1, 17], gs[1][0, 5], gs[2][0, 9] = np.nan, np.inf, -np.inf
        idxs[0][17], idxs[1][5], idxs[2][9] = 3, 4, 4   # inf - inf = NaN
        idxs[1][6], gs[1][:, 6] = 5, np.inf
    data = rs.normal(size=(P, 3)).astype(np.float32)
    got = tfold.fold_updates(
        torch.from_numpy(data), [torch.from_numpy(i) for i in idxs],
        [tuple(torch.from_numpy(g[a]) for a in range(3)) for g in gs])
    want = flat(data, np.concatenate(idxs), np.concatenate(gs, axis=1))
    got = got.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    if case == "non_finite":
        assert np.isnan(got[3, 1]) and np.isnan(got[4, 0])
        assert np.isposinf(got[5]).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-5 * np.abs(want[fin]).max())


def test_kernels_on_refuses_cpu_tensors():
    z = torch.zeros(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfold.sorted_fold(torch.zeros((8, 3)),
                          torch.zeros(4, dtype=torch.int32), z, z, z,
                          kernels="on")
