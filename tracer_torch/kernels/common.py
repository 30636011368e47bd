"""Shared pieces of the port's kernel wrappers: dispatch between a CUDA
kernel and its plain PyTorch version, and the checks a wrapper makes before
it launches.

The dispatch rule (`RenderConfig.kernels`): "auto" launches the kernel for
a CUDA tensor and takes the plain version for a CPU tensor; "on" launches
the kernel and raises for a CPU tensor; "off" takes the plain version on
any device. A CUDA tensor never falls back: the kernel launches or the
wrapper raises.
"""

from __future__ import annotations

import torch


def use_kernel(mode: str, t: torch.Tensor) -> bool:
    if mode == "off":
        return False
    if mode not in ("auto", "on"):
        raise ValueError(f"unknown kernels mode: {mode!r}")
    if t.is_cuda:
        return True
    if mode == "on":
        raise RuntimeError("kernels='on' needs CUDA tensors; got "
                           f"{t.device} (use 'auto' or 'off' on the CPU)")
    return False


def check(name: str, t: torch.Tensor, dtype, shape, device) -> int:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device`; return its data pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def raise_on_error(kernel: str, err: int) -> None:
    """The C launchers return cudaGetLastError() right after the launch."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
