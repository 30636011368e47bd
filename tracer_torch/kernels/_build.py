"""Build and load the port's CUDA kernels.

At first use, `nvcc` compiles every `csrc/*.cu` into one shared library
with a plain C interface, which is loaded with `ctypes` (no PyTorch headers,
so a build takes seconds). The library lands in `build/tracer_torch/`
under a name keyed by a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused.

Flags: `sm_90a` (Hopper); `--fmad=false` because PyTorch's eager ops
round every product and sum on its own, so with it the kernels reproduce
their plain versions bit for bit (a contracted candidate `t` would flip
the winning primitive at near-ties); never `--use_fast_math`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LIB = None
BUILD_SECONDS = None   # wall time of the nvcc call this process made
PTXAS_INFO = ""        # nvcc's -Xptxas -v report (registers, smem, spills)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset and "
                           "nvcc is not on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB, BUILD_SECONDS, PTXAS_INFO
    if _LIB is not None:
        return _LIB
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = CSRC.parents[2] / "build" / "tracer_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"tracer_torch_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               *map(str, srcs)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS = time.perf_counter() - t0
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}")
        PTXAS_INFO = res.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    # the C ABI: a pointer to an argument struct (mirrored by a
    # ctypes.Structure in the kernel's module), then the CUDA stream; each
    # returns cudaGetLastError() after its launch
    lib.tt_first_hits.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.tt_first_hits.restype = ctypes.c_int
    lib.tt_shade_scatter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.tt_shade_scatter.restype = ctypes.c_int
    _LIB = lib
    return _LIB
