"""The readers of the card's idle time inside the program's spans
(`span_idle.idle_share_in`, `metrics/{finish,launch}_idle.render.py`,
`metrics/{launch,optimizer}_idle.train.py`) on hand-built traces: the
worked case, spans missing, overlapping operations and spans counted
once, and each reading a part of `idle_share.*` on the same trace."""

import random

import pytest

from portbench import core, span_idle
from portbench.trace import DeviceOp, Span, Trace

RENDER = ("finish_idle.render", "launch_idle.render")
TRAIN = ("launch_idle.train", "optimizer_idle.train")


def read(name, tr):
    return core.metric_reader(name)({"trace": tr})


def test_the_worked_case():
    """Window 0-100 us, the card busy 0-40, `render.copy_out` 30-50 and
    `render.to_image` 50-80: idle in the finish 40-80, 40% of the
    window."""
    tr = Trace([DeviceOp("k", 0.0, 40.0, 0)],
               [Span("render.copy_out", 30.0, 20.0),
                Span("render.to_image", 50.0, 30.0)], 0.0, 100.0)
    assert span_idle.idle_share_in(
        tr, ("render.copy_out", "render.to_image")) == pytest.approx(40.0)
    assert read("finish_idle.render", tr) == pytest.approx(40.0)


def test_missing_spans_give_none():
    ops = [DeviceOp("k", 0.0, 40.0, 0)]
    bare = Trace(ops, [Span("frame", 0.0, 100.0)], 0.0, 100.0)
    for name in RENDER + TRAIN:
        assert read(name, bare) is None, name
        assert core.metric_reader(name)({}) is None, name
    # one of the two finish spans is not enough
    half = Trace(ops, [Span("render.copy_out", 30.0, 20.0)], 0.0, 100.0)
    assert read("finish_idle.render", half) is None
    # a span outside the window still counts as present, and reads 0
    out = Trace(ops, [Span("step.optimizer", 120.0, 5.0)], 0.0, 100.0)
    assert read("optimizer_idle.train", out) == 0.0


def test_overlapping_ops_and_spans_count_once():
    """Ops on two streams and two cards overlap; a span nested in another
    of the same set and two overlapping ones: each idle microsecond is
    counted once."""
    ops = [DeviceOp("a", 0.0, 30.0, 0), DeviceOp("b", 20.0, 20.0, 0),
           DeviceOp("nccl", 10.0, 25.0, 1), DeviceOp("c", 60.0, 10.0, 0)]
    spans = [Span("step.launch", 30.0, 50.0),     # 30-80
             Span("step.launch", 40.0, 10.0),     # 40-50, inside
             Span("step.launch", 70.0, 20.0),     # 70-90, overlaps
             Span("step.prepare", 35.0, 5.0)]     # a child, not named
    tr = Trace(ops, spans, 0.0, 100.0)
    # inside 30-90 (60 us), busy there 30-40 and 60-70 (20 us)
    assert read("launch_idle.train", tr) == pytest.approx(40.0)


def test_ops_starting_outside_the_window_are_not_busy():
    """As `trace.busy_us` takes them: an op that started before the
    window does not make the card busy inside it."""
    tr = Trace([DeviceOp("k", -10.0, 30.0, 0)],
               [Span("step.optimizer", 0.0, 20.0)], 0.0, 100.0)
    assert read("optimizer_idle.train", tr) == pytest.approx(20.0)
    assert read("idle_share.train", tr) == pytest.approx(100.0)


def _random_trace(rng, names, extra):
    """Ops on two cards over 0-1000 us, the last ending by the window's
    end (a traced window ends after a synchronise), and the host's
    consecutive phases drawn from `names`; with `extra`, one more span of
    each name at a random time, overlapping the phases."""
    ops = []
    t = 0.0
    while t < 1000.0:
        d = min(rng.uniform(1.0, 40.0), 1000.0 - t)
        ops.append(DeviceOp("k", t, d, rng.randrange(2)))
        t += d * rng.uniform(0.2, 2.0)
    spans = [Span("frame", 0.0, 1000.0)]
    t = 0.0
    while t < 1000.0:
        d = rng.uniform(5.0, 80.0)
        spans.append(Span(rng.choice(names), t, d))
        t += d
    spans += [Span(n, rng.uniform(0.0, 900.0) if extra else 2000.0, 10.0)
              for n in names]       # every name present
    return Trace(ops, spans, 0.0, 1000.0)


@pytest.mark.parametrize("seed", range(5))
def test_each_reading_is_a_part_of_the_idle_share(seed):
    for metrics, idle, names in (
            (RENDER, "idle_share.render",
             ("render.launch", "render.copy_out", "render.to_image")),
            (TRAIN, "idle_share.train", ("step.launch", "step.optimizer"))):
        rng = random.Random(seed)
        tr = _random_trace(rng, names, extra=True)
        whole = read(idle, tr)
        parts = [read(m, tr) for m in metrics]
        assert all(0.0 <= p <= whole + 1e-9 for p in parts), (parts, whole)
        # spans that do not overlap, as one host thread's phases: the
        # readings add up to at most the idle share
        tr = _random_trace(rng, names, extra=False)
        parts = [read(m, tr) for m in metrics]
        assert sum(parts) <= read(idle, tr) + 1e-9, parts
        assert sum(parts) > 0.0
