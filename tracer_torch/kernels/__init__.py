"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of the
JAX package, each beside its plain PyTorch version (see kernels/common.py
for the dispatch rule and kernels/_build.py for the build)."""
