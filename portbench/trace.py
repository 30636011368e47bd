"""The device trace of a traced run: `torch.profiler` over a steady part
of the window, exported as a Chrome trace into the checkout's
`.portbench/` and read back as plain tuples, then reduced to what the
metric readers and the result's `breakdown` take.

An operation on the device is a kernel, a copy or a set ("cat" kernel,
gpu_memcpy, gpu_memset). The card's busy time is the union of their
intervals (on any stream), so overlapping streams are not counted twice;
idle is the traced window less that union. A harness span is a
`record_function` range named "span:<name>" on the host.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Callable, NamedTuple

from portbench import core

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_DIR = core.ROOT / ".portbench"


class DeviceOp(NamedTuple):
    name: str
    start: float      # us, the trace's clock
    dur: float        # us
    device: int


class Span(NamedTuple):
    name: str
    start: float
    dur: float


class Trace(NamedTuple):
    ops: list          # [DeviceOp]
    spans: list        # [Span]
    start: float       # the traced window on the trace's clock, us
    end: float


def record(fn: Callable[[], None], spans: core.Spans, tag: str) -> Trace:
    """Run `fn` under the profiler (host and device activities) with the
    harness's spans recorded as ranges; the window is the outermost range
    "window:<tag>" around `fn` and the synchronise that ends it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    TRACE_DIR.mkdir(exist_ok=True)
    path = TRACE_DIR / f"trace_{tag}_{os.getpid()}.json"
    spans.traced = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("window:" + tag):
                fn()
                torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
    finally:
        spans.traced = False
    try:
        return parse(path, tag)
    finally:
        path.unlink(missing_ok=True)


def parse(path: pathlib.Path, tag: str) -> Trace:
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ops, spans = [], []
    start = end = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev = (e.get("args") or {}).get("device", 0)
            ops.append(DeviceOp(name, ts, dur, int(dev or 0)))
        elif cat == "user_annotation":
            if name == "window:" + tag:
                start, end = ts, ts + dur
            elif name.startswith("span:"):
                spans.append(Span(name[5:], ts, dur))
    if start is None:
        raise RuntimeError(f"trace {path}: no window range")
    return Trace(sorted(ops, key=lambda o: o.start), spans, start, end)


def busy_intervals(ops) -> list:
    """The union of the operations' intervals, sorted and merged."""
    out = []
    for o in sorted(ops, key=lambda o: o.start):
        a, b = o.start, o.start + o.dur
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(
        [o for o in tr.ops if tr.start <= o.start <= tr.end]))


def op_us(tr: Trace, patterns) -> tuple:
    """(us, count) of the device operations whose name holds one of the
    patterns."""
    hit = [o for o in tr.ops if any(p in o.name for p in patterns)]
    return sum(o.dur for o in hit), len(hit)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time (seconds, summed by
    name) and the longest idle gaps, each named by the harness span open
    at the gap's middle."""
    by_name = {}
    for o in tr.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + o.dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    prev = tr.start
    for a, b in busy_intervals(tr.ops) + [[tr.end, tr.end]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    named = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        open_ = [s for s in tr.spans if s.start <= mid <= s.start + s.dur]
        # the innermost span open then: the one that started last
        label = (max(open_, key=lambda s: s.start).name if open_
                 else "outside the harness's spans")
        named.append([label, (b - a) * 1e-6])
    return {"device_ops": [[n, us * 1e-6] for n, us in ops],
            "idle_gaps": named}
