"""The plain reference of the benchmark's check: a path tracer in plain
PyTorch (`integrator.py`, `render.py`) on its own scene tables
(`scene.py`, `builder.py`, `bvh.py`), with the kernels' plain versions
(`plain.py`) and the shading, intersection and random-stream modules
frozen from the port. It imports nothing of the port and takes nothing
the port made: the harness hands it the recipe's arrays, the poses, the
seeds and the start values."""
