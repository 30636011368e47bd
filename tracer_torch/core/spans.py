"""The port's spans: named phases of a frame or a training step, recorded
as `torch.profiler` ranges.

    with span("render.copy_out"):
        film[lo:hi] = rad.cpu().numpy()

While a `torch.profiler` profile runs, `span(name)` is a
`record_function` range named "span:<name>", so the phases sit in the
profile's Chrome trace on the clock of the card's kernels and copies,
and every idle gap of the card lies inside the phase the host was in
(`python -m tracer_torch.cli benchmark --profile DIR`; the benchmark's
traced runs, whose gaps `portbench/trace.py::breakdown` names by the
innermost span open). Otherwise it does nothing: one read of the
profiler's flag, a fraction of a microsecond (a bare `record_function`
costs ~9 µs even with no profiler running).

Names are "<layer>.<phase>": `render.*` (renderer, sharded frame),
`graph.*` (the graph cache), `step.*` (the training step). Spans nest on
the host thread, inside the caller's frame or step. None is opened inside
a captured body: a replay runs no host code.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the range "span:<name>" while a profiler runs,
    else nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function("span:" + name)
