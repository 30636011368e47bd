"""The harness's shared parts: the cell as `BENCHMARK.json` and the files
it names give it, the harness's spans, the device's description, the
look for JAX in the process, and the result's last line.

Everything of one configuration, one traffic mix or one per-layer metric
lives in a file of its own, found by name: `configs/<config>.json`,
`traffic/<traffic>.json` (its `entry` names the driver in `drivers/`),
`limits/<cell>.json` (the check's limits) and `metrics/<metric>.py`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys
import time
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that must not be loaded in a run: the JAX
# package, JAX and its neighbours (compared whole, so `tracer_torch`
# passes)
BANNED = ("jax", "jaxlib", "flax", "tracer")


class SetupError(RuntimeError):
    """The run cannot start: no card, too few cards, or a file missing."""


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of `workloads` with everything it names."""
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # limits/<cell>.json
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench_path = root / "BENCHMARK.json"
    if not bench_path.exists():
        raise SetupError(f"{bench_path} is missing")
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SetupError(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    here = root / "portbench"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(here / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def driver(cell: Cell):
    """The driver module the traffic's `entry` names."""
    return importlib.import_module(f"portbench.drivers.{cell.traffic['entry']}")


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """`metrics/<name>.py`'s `read`, loaded by its path (a metric's name
    may hold dots)."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    """The banned top-level names loaded in this process."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


class Spans:
    """The harness's spans: (name, start, end) on the host's clock, kept
    in memory. While a profiler runs (`traced`), each span is also a
    `record_function` range, so the trace labels the device's idle gaps
    by the span open during them."""

    def __init__(self):
        self.spans = []
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.traced:
            import torch
            with torch.profiler.record_function("span:" + name):
                yield
        else:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    def seconds(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def device(count: int) -> dict:
    """The `device` of the result line: platform, the card's name, the
    cards used and the peak memory allocated on this process's card."""
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def result(correct: bool, attempted: int, failed: int, metrics: dict,
           dev: dict, compared: dict, breakdown: Optional[dict] = None
           ) -> dict:
    """The last line's object. `compared`: {name: {"value", "limit"}} of
    every number the check compared, last in the line."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return out


def emit(res: dict) -> None:
    """Each compared number beside its limit on standard error, then the
    result as the last line of standard output."""
    for name, c in res["compared"].items():
        print(f"compared {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
