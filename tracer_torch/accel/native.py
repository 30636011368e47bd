"""ctypes binding to the native C++ BVH builder (`accel/csrc/bvh_builder.cpp`,
the port's copy of `native/bvh_builder.cpp`).

At first use g++ builds the source into `build/tracer_torch/` under a name
keyed by a hash of the source, the flags and the host (`-march=native`
ties the library to the CPU it was built on), with the flags of
`native/Makefile`, so both packages build the same tree. Unlike the JAX
package, which falls back to numpy silently when the build fails, a failed
build raises: `compile_scene(use_native=True)` gets the SAH tree or an
error, and `use_native=False` takes the numpy median-split builder.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import platform
import subprocess
import tempfile

import numpy as np

from tracer_torch.accel.bvh import FlatBVH

SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "bvh_builder.cpp"
BUILD_DIR = SRC.parents[3] / "build" / "tracer_torch"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall"]

_LIB = None


def library() -> ctypes.CDLL:
    """The loaded builder library, built on first call (raises if g++
    fails)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(f"{platform.node()} {platform.machine()}".encode())
    out_dir = BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"bvh_builder_{h.hexdigest()[:16]}.so"
    if not so.exists():
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp_so = pathlib.Path(tmp) / "lib.so"
            p = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp_so),
                                str(SRC)], capture_output=True, text=True)
            if p.returncode != 0:
                raise RuntimeError(f"g++ failed ({p.returncode}) building "
                                   f"{SRC}:\n{p.stdout}\n{p.stderr}")
            tmp_so.replace(so)
    lib = ctypes.CDLL(str(so))
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tracer_build_bvh.restype = ctypes.c_int
    lib.tracer_build_bvh.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(f32p), ctypes.POINTER(f32p),
        ctypes.POINTER(i32p), ctypes.POINTER(i32p), ctypes.POINTER(i32p),
        i32p, i32p,
    ]
    lib.tracer_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def build_bvh_native(tri_lo: np.ndarray, tri_hi: np.ndarray,
                     leaf_width: int = 4, max_depth: int = 64) -> FlatBVH:
    """Binned-SAH BVH over per-triangle boxes, built in C++."""
    lib = library()
    tri_lo = np.ascontiguousarray(tri_lo, np.float32)
    tri_hi = np.ascontiguousarray(tri_hi, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    node_lo, node_hi = f32p(), f32p()
    leaf_start, skip, leaf_tris = i32p(), i32p(), i32p()
    n_nodes, n_slots = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.tracer_build_bvh(
        tri_lo.ctypes.data_as(f32p), tri_hi.ctypes.data_as(f32p),
        tri_lo.shape[0], leaf_width, max_depth,
        ctypes.byref(node_lo), ctypes.byref(node_hi),
        ctypes.byref(leaf_start), ctypes.byref(skip),
        ctypes.byref(leaf_tris), ctypes.byref(n_nodes), ctypes.byref(n_slots))
    if rc != 0:
        raise RuntimeError(f"tracer_build_bvh returned {rc}")
    B, S = n_nodes.value, n_slots.value

    def take(ptr, count, dtype):
        if count == 0:
            return np.zeros(0, dtype)
        arr = np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype).copy()
        lib.tracer_free(ptr)
        return arr

    return FlatBVH(
        node_lo=take(node_lo, 3 * B, np.float32).reshape(-1, 3),
        node_hi=take(node_hi, 3 * B, np.float32).reshape(-1, 3),
        node_leaf_start=take(leaf_start, B, np.int32),
        node_skip=take(skip, B, np.int32),
        leaf_tris=take(leaf_tris, S, np.int32),
        leaf_width=leaf_width,
        n_nodes=B,
    )
