"""Finite-difference gradient checking (the port of `tracer/diff/fd.py`).

The discrete decisions inside the tracer (closest-hit argmin, Bernoulli
draws) are not differentiable; the gradient flows through the analytic
re-evaluation of the selected primitive only. Central differences therefore
match it away from visibility discontinuities, and both sides of a probe
replay the same random draws because every draw is a pure function of
(seed, pixel, sample, bounce) (tracer_torch/core/rng.py).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def fd_gradient(loss: Callable, p0, eps: float = 1e-3) -> np.ndarray:
    """Central finite differences of `loss` (a float32 tensor -> scalar
    tensor) at p0 (any array shape), in float64."""
    p0 = np.asarray(p0, np.float64)
    flat = p0.reshape(-1)
    g = np.zeros_like(flat)
    for i in range(flat.size):
        dp = np.zeros_like(flat)
        dp[i] = eps
        lp = float(loss(torch.tensor((flat + dp).reshape(p0.shape),
                                     dtype=torch.float32)))
        lm = float(loss(torch.tensor((flat - dp).reshape(p0.shape),
                                     dtype=torch.float32)))
        g[i] = (lp - lm) / (2 * eps)
    return g.reshape(p0.shape)


def compare_ad_fd(loss: Callable, p0, eps: float = 1e-3,
                  atol: float = 1e-2, rtol: float = 5e-2):
    """Returns (g_ad, g_fd, max_abs_err, ok): the autograd gradient of
    `loss` at p0 against central differences."""
    p = torch.tensor(np.asarray(p0), dtype=torch.float32, requires_grad=True)
    (g_ad,) = torch.autograd.grad(loss(p), p)
    g_ad = g_ad.detach().numpy().astype(np.float64)
    g_fd = fd_gradient(loss, p0, eps)
    err = np.abs(g_ad - g_fd)
    ok = bool((err < atol + rtol * np.maximum(np.abs(g_fd), 1.0)).all())
    return g_ad, g_fd, float(err.max()), ok
