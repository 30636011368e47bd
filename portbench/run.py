"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

builds the cell's inputs from the seed, warms up the cell's shapes (set-up,
`setup_s`), measures for `--seconds`, checks the window's outputs against
the plain reference (`check.py`) and prints one JSON object as the last
line of standard output: the end-to-end metrics with `--trace 0`, the
per-layer metrics (and `device.busy_s`, `device.window_s`, `breakdown`)
with `--trace 1`. `--control 1` also prints the control's reading of
each compared number (the reference in bfloat16 in the program's place)
on standard error; no result of a benchmark run depends on it.

Exits non-zero, printing no result, without a CUDA card or with fewer
cards than the cell asks for, where a file of the cell is missing, or
where the process has loaded JAX or the JAX package by the end.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    # the program's build and kernel caches stay inside the checkout, at
    # fixed paths (the kernels build into build/tracer_torch/ there)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".portbench" /
                                                  "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".portbench" /
                                                      "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # Python's byte code of every module the run imports, torch's too,
    # cached at a fixed path inside the checkout (for the spawned ranks
    # too): where the installation holds none and the environment forbids
    # writing it (PYTHONDONTWRITEBYTECODE), every run would compile
    # torch's and torch._dynamo's sources again, ~10 s of set-up that
    # swings with the host's load
    sys.pycache_prefix = str(ROOT / ".portbench" / "pycache")
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

    from portbench import core
    try:
        cell = core.load_cell(a.workload)
    except (core.SetupError, OSError, KeyError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    import torch
    import_torch_s = time.perf_counter() - t0
    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    res, extra = core.driver(cell).run(cell, a.seed, a.seconds,
                                       bool(a.trace), T_START,
                                       control=bool(a.control))
    found = core.banned_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 4
    extra["import_torch_s"] = import_torch_s
    print("extra " + json.dumps(extra), file=sys.stderr, flush=True)
    core.emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
