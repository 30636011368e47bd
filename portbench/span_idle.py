"""The card's idle time inside the program's own spans: the share of a
traced window in which the card is idle while the host is inside one of
the named `span:<name>` ranges (`tracer_torch/core/spans.py`; a child
range lies inside its parent, so naming the parent counts the children).

The card's busy set is `idle_share.*`'s: the union of the intervals of
the kernels, copies and sets that start in the window, as
`trace.busy_us` takes them. The traced window ends after a synchronise,
so those operations end inside it, and each reading is a part of the
matching `idle_share.*` of the same trace: readings over spans that do
not overlap add up to at most it.
"""

from __future__ import annotations

from typing import Optional

from portbench import trace


def _overlap_us(xs: list, ys: list) -> float:
    """The length of the intersection of two sorted, merged lists of
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(tr: trace.Trace, names) -> Optional[float]:
    """100 x the window's time in which the card is idle and the host is
    inside a span named in `names`, over the window's length; None where
    one of the names has no span in the trace (a program without them)."""
    names = set(names)
    spans = [s for s in tr.spans if s.name in names]
    if {s.name for s in spans} != names:
        return None
    inside = [[max(a, tr.start), min(b, tr.end)]
              for a, b in trace.busy_intervals(spans)]
    inside = [[a, b] for a, b in inside if b > a]
    busy = trace.busy_intervals(
        [o for o in tr.ops if tr.start <= o.start <= tr.end])
    idle_us = sum(b - a for a, b in inside) - _overlap_us(inside, busy)
    return 100.0 * idle_us / (tr.end - tr.start)
