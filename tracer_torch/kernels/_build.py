"""Build and load the port's CUDA kernels.

At first use, `nvcc` compiles every `csrc/*.cu` into an object file, one
`nvcc` process per source, all started together, and links them into one
shared library with a plain C interface, which is loaded with `ctypes` (no
PyTorch headers, so a build takes seconds). The library lands in
`build/tracer_torch/` under a name keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

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
              "--fmad=false", "-Xcompiler", "-fPIC"]

_LIB = None
BUILD_SECONDS = None   # wall time of the nvcc call this process made
PTXAS_INFO = ""        # nvcc's -Xptxas -v report (registers, smem, spills)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset and "
                           "nvcc is not on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_all(cmds) -> list:
    """Run the commands at once; raise if one fails, else return their
    standard errors (nvcc's -Xptxas -v report lands there)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{out}\n{err}")
    return [err for _, err in outs]


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
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            objs = [os.path.join(tmp, p.stem + ".o") for p in srcs]
            info = _run_all([[_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                              "-o", obj, str(src)]
                             for src, obj in zip(srcs, objs)])
            _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o",
                       os.path.join(tmp, "lib.so"), *objs]])
            os.replace(os.path.join(tmp, "lib.so"), so)
        BUILD_SECONDS = time.perf_counter() - t0
        PTXAS_INFO = "".join(info)
    lib = ctypes.CDLL(str(so))
    # the C ABI: a pointer to an argument struct (mirrored by a
    # ctypes.Structure in the kernel's module), then the CUDA stream; each
    # returns cudaGetLastError() after its launch
    lib.tt_first_hits.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.tt_first_hits.restype = ctypes.c_int
    lib.tt_shade_scatter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.tt_shade_scatter.restype = ctypes.c_int
    lib.tt_bounce_bwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.tt_bounce_bwd.restype = ctypes.c_int
    lib.tt_sorted_fold.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.tt_sorted_fold.restype = ctypes.c_int
    lib.tt_traverse.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.tt_traverse.restype = ctypes.c_int
    lib.tt_shadow.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.tt_shadow.restype = ctypes.c_int
    lib.tt_row_sum.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.tt_row_sum.restype = ctypes.c_int
    lib.tt_finish.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.tt_finish.restype = ctypes.c_int
    lib.tt_camera.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.tt_camera.restype = ctypes.c_int
    _LIB = lib
    return _LIB
