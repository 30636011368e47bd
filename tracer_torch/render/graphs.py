"""Compiled entry points: the port's counterpart of `jax.jit` at the JAX
package's jitted entry points (`render_pixels`, whose frame is one XLA
program with the samples in a `lax.scan`; `fit`'s step on every scene,
both `custom_vjp` modes and `mesh=`; the CLI's `benchmark --occupancy`
frame; the sharded frame of `render_image_multihost`; `bench.py`'s
`jax.jit(frame)` and `jax.jit(gsum)`), as CUDA graphs.

A `GraphCache` maps a key to a captured graph. The first call with a new
key runs the body eagerly on a side stream (the warm-up: on first use it
also builds the kernels with nvcc and fills the launchers' per-process
memos, the occupancy queries and shared-memory attributes), then makes
static copies of the body's arguments and captures the body on them as a
CUDA graph on the same side stream (`torch.cuda.CUDAGraph`, a private
memory pool of its own, global capture mode). Every later call with that
key copies into the static copies the arguments that changed, replays the
graph on the current stream and returns a copy of the static outputs,
which the next replay overwrites. So an entry point replays from its
second call on.

- **Where.** Graphs run on the card only. One written rule,
  `GraphCache.active(t, cfg, mesh)`, decides for every route
  (`renderer.render_frame`, `train.make_step`, `bench`,
  `cli.occupancy_frame`, `dist.sharding.sharded_sum`): a route takes a
  graph for CUDA tensors with `kernels` on ("auto" or "on") outside
  `disabled()`, on every scene (the hand-written and the general
  backward, the plain autodiff route), except a route over a mesh whose
  collectives a capture cannot hold (`RayMesh.capturable`: gloo's run on
  the host). On CPU tensors, with `kernels="off"` (the plain versions,
  the reference on the card), over a gloo mesh and inside `disabled()` a
  route runs its eager body, as `jax.disable_jit` does; never because a
  capture failed. On a mesh the warm-up runs the collectives first, so
  NCCL's communicator exists before a captured collective.
  (`dist.sharding.train_step`, a one-shot step, runs eagerly.)
- **The key: the arguments by shape, as `jax.jit` keys them.** The body
  reads nothing but its arguments (a pytree: the scene and camera
  dataclasses, leaves, target, pixel ids, rays, the seed word, the
  frame's tables) and what the caller's key names by value (the entry
  point's name, the config, width, height, samples where JAX has them
  static, a mesh's shape and coordinate). The cache adds the arguments'
  `signature`: each tensor by `meta` (shape, dtype, strides, device,
  `requires_grad`, not its address or its values), every other leaf by
  value (the dataclasses' ints, bools and tuples; the tables' host
  constants), and which arguments are one tensor twice (a training leaf
  is also its scene's field). So a new camera, scene of the same shapes,
  seed or set of leaves replays the graph. Strides are in the key where
  JAX has none, because a torch tensor can arrive in any layout and a
  reduction may follow it.
- **Static copies.** At capture the cache copies every argument tensor
  once (one copy for a tensor that appears twice); a tensor that requires
  grad becomes a leaf of its own (`detach().clone().requires_grad_()`),
  whose `.grad` the captured backward writes. At each call it copies in
  only the arguments that are another tensor than the one it last copied
  there or were written in place since (the tensor's `_version`, which
  every in-place op bumps): Adam's update makes a step's leaves copy in
  at every step, a scene's other tensors copy in once.
- **The seed and the samples.** The seed enters as its word in a 0-d
  tensor (`rng.seed_tensor`), like any argument. A frame's samples are
  `lax.scan`'s counterpart (`call(carry=, steps=)`): the graph holds one
  sample (`acc += trace(sample idx)`, then `idx += 1`, on the static
  `acc` and `idx`) and a call replays it once a sample, so one graph
  serves every spp and first sample. A step stays one graph a step with
  its samples static, as in JAX's `make_step`.
- **Host constants.** A frame's host reads (`integrator.host_constants`:
  `dark_sky`, an image sky's size) are made before the warm-up, from the
  caller's scene, into the frame's tables (`integrator.prepare`), which
  the body takes as an argument: the values are baked into the kernels'
  arguments, so they are in the key by value. It is the one place the
  port keys on a value JAX traces (a new `dark_sky` value is a new key;
  no `train.py` field trains it).
- **Launch counts.** A kernel wrapper adds one to its module's `LAUNCHES`
  where it launches; a replay runs no wrapper. The cache records each
  counter's increase during the capture (which launches nothing), takes it
  back, and adds it again at every replay, so the counts still say which
  kernels ran how often.
- **A failed capture raises** the body's error (a read of the card inside
  the body is refused by the capture); nothing is cached and there is no
  eager fallback.
- **Spans** (`core/spans.py`, ranges in a `torch.profiler` trace): a
  capture's `graph.warmup` and `graph.capture` (with the instantiation),
  a call's `graph.copy_in` and `graph.replay` (all its replays, one
  span), each around the host code that enqueues them, never inside a
  captured body.
- **Size.** At most `max_graphs` graphs (8 by default), least recently
  used first out; an evicted graph's pool goes back to the card. A
  16-spp protocol step's pool holds about what the step's peak does
  (3.8-4.4 GB on 850x480, PERF.md section 5), a frame's sample graph
  much less.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from collections import OrderedDict
from dataclasses import fields, is_dataclass, replace
from typing import Callable, Optional

import torch

from tracer_torch.core.spans import span
from tracer_torch.kernels import camera as kcamera
from tracer_torch.kernels import fold as kfold
from tracer_torch.kernels import intersect as kintersect
from tracer_torch.kernels import rowsum as krowsum
from tracer_torch.kernels import shade as kshade
from tracer_torch.kernels import shade_bwd as kbwd
from tracer_torch.kernels import shadow as kshadow
from tracer_torch.kernels import traverse as ktraverse

# the modules whose LAUNCHES a replay adds to
COUNTED = dict(first_hits=kintersect, shade_scatter=kshade,
               bounce_bwd=kbwd, sorted_fold=kfold, traverse=ktraverse,
               shadow=kshadow, row_sum=krowsum, camera=kcamera)


def launch_counts() -> dict:
    return {k: m.LAUNCHES for k, m in COUNTED.items()}


def meta(t: torch.Tensor):
    """A tensor's part of a graph's key: its shape, dtype, strides, device
    and `requires_grad`, not its address or its values."""
    return ("tensor", tuple(t.shape), t.dtype, t.stride(), t.device,
            t.requires_grad)


def signature(x):
    """A hashable description of `x` for a graph's key: a tensor by
    `meta`; dataclasses (with their field names), dicts, tuples and lists
    by their parts; anything else by value (it must be hashable: ints,
    floats, strings, None)."""
    if isinstance(x, torch.Tensor):
        return meta(x)
    if is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, signature(getattr(x, f.name))) for f in fields(x))
    if isinstance(x, dict):
        return tuple((k, signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (tuple, list)):
        return tuple(signature(v) for v in x)
    hash(x)
    return x


def tensors(x) -> list:
    """The tensors of the pytree `x`, in `signature`'s order (a tensor
    that appears twice, twice)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if is_dataclass(x) and not isinstance(x, type):
        parts = [getattr(x, f.name) for f in fields(x)]
    elif isinstance(x, dict):
        parts = [x[k] for k in sorted(x)]
    elif isinstance(x, (tuple, list)):
        parts = x
    else:
        return []
    return [t for p in parts for t in tensors(p)]


def tree_map(fn, x):
    """`x` with each tensor t replaced by fn(t): dataclasses (by
    `dataclasses.replace`), named tuples, tuples, lists and dicts by their
    parts; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if is_dataclass(x) and not isinstance(x, type):
        return replace(x, **{f.name: tree_map(fn, getattr(x, f.name))
                             for f in fields(x)})
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    return x


def key_of(key, args=(), carry=()):
    """(the key under which `GraphCache.call(key, body, args, carry)`
    caches its graph, the distinct tensors of `args` in order). The full
    key holds the caller's `key`, the arguments' `signature`, which of
    them are one tensor twice, and the carry's `meta`."""
    ts = tensors(args)
    first = {}
    alias = tuple(first.setdefault(id(t), i) for i, t in enumerate(ts))
    full = (key, signature(args), alias, tuple(meta(c) for c in carry))
    return full, [t for i, t in enumerate(ts) if alias[i] == i]


def _stamp(t: torch.Tensor):
    """What says that `t` is the tensor last copied and was not written
    since: (a weak reference to it, its address, its version)."""
    return weakref.ref(t), t.data_ptr(), t._version


class Graph:
    """One captured body: the graph, its static inputs (one a distinct
    argument tensor, with the stamp of the tensor last copied into it),
    carry and outputs, the launches a replay stands for, and what its
    capture cost (seconds of the warm-up, the capture and the
    instantiation; the bytes its pool reserved). `replays` counts the
    calls answered by replaying it, `runs` the replays of the graph (a
    frame's call runs it once a sample)."""

    def __init__(self, key, graph, inputs, stamps, carry, outputs,
                 launches, times, pool_bytes):
        self.key, self.graph = key, graph
        self.inputs, self.stamps = inputs, stamps
        self.carry, self.outputs = carry, outputs
        self.launches = launches
        self.times, self.pool_bytes = times, pool_bytes
        self.replays = self.runs = 0

    @torch.no_grad()
    def copy_in(self, unique, carry):
        """Copy into the static inputs the distinct argument tensors
        `unique` that are not the tensors last copied there or were
        written since, and the carry, always."""
        for i, x in enumerate(unique):
            ref, ptr, version = self.stamps[i]
            if ref() is not x or ptr != x.data_ptr() or version != x._version:
                self.inputs[i].copy_(x)
                self.stamps[i] = _stamp(x)
        for s, x in zip(self.carry, carry):
            s.copy_(x)


class CudaBackend:
    """Warm-up, capture and release on the card. The warm-up and the
    capture run on one side stream per device (a capture needs a stream
    other than the default one, and the warm-up there also creates what a
    stream needs on first use, such as cuBLAS's workspace)."""

    def __init__(self):
        self._side = {}

    def _stream(self):
        dev = torch.cuda.current_device()
        if dev not in self._side:
            self._side[dev] = torch.cuda.Stream(dev)
        return self._side[dev]

    def warm_up(self, body, inputs):
        cur, side = torch.cuda.current_stream(), self._stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = body(*inputs)
        cur.wait_stream(side)
        # the result was made on the side stream and is used on this one
        tree_map(lambda t: t.record_stream(cur), out)
        return out

    def capture(self, body, inputs):
        """(graph, outputs, {capture_s, instantiate_s}, pool bytes)."""
        side = self._stream()
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="global")
            try:
                out = body(*inputs)
            except BaseException:
                # end the capture the body's error broke, then raise that
                # error, not the one ending it gives
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        t1 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pool = torch.cuda.memory_reserved() - reserved
        return graph, out, dict(capture_s=t1 - t0, instantiate_s=t2 - t1), \
            pool

    def release(self):
        torch.cuda.empty_cache()


class GraphCache:
    """Captured bodies by key (module docstring), least recently used
    first out beyond `max_graphs`. `backend` warms up, captures and
    releases (`CudaBackend`; the CPU tests give a stub)."""

    def __init__(self, max_graphs: int = 8, backend=None):
        self.max_graphs = max_graphs
        self.backend = backend if backend is not None else CudaBackend()
        self.enabled = True
        self.captures = 0
        self.last: Optional[Graph] = None    # the last graph captured
        self._graphs: "OrderedDict[tuple, Graph]" = OrderedDict()

    def __len__(self):
        return len(self._graphs)

    def __contains__(self, key):
        """Whether a graph of the caller's `key` is cached (for any
        arguments' shapes)."""
        return any(g.key == key for g in self._graphs.values())

    def graphs(self):
        return list(self._graphs.values())

    def active(self, t: torch.Tensor, cfg, mesh=None) -> bool:
        """The rule (module docstring): whether an entry point on `t`'s
        device with config `cfg`, over `mesh` (`dist.sharding.RayMesh`;
        None unsharded), takes a graph: graphs not disabled, a tensor on
        the card, the kernels on, and the mesh's collectives capturable."""
        return (self.enabled and self.on_card(t) and cfg.kernels != "off"
                and (mesh is None or mesh.capturable))

    def on_card(self, t: torch.Tensor) -> bool:
        return t.is_cuda

    @contextlib.contextmanager
    def disabled(self):
        """Every entry point runs its eager body inside (`jax.disable_jit`);
        the cache itself is kept."""
        was, self.enabled = self.enabled, False
        try:
            yield
        finally:
            self.enabled = was

    def call(self, key, body: Callable, args=(), carry=(), steps=1):
        """`body(*args, *carry)`, a pytree of tensors, by the graph of
        `key` and the arguments' `signature`: replayed if cached, else the
        warm-up's result, with the body then captured on static copies of
        `args` and `carry` (module docstring). The body reads nothing but
        `args` and what `key` holds by value.

        `carry`: tensors the body updates in place (`lax.scan`'s carry: a
        sum and a sample index), copied in at every call. The body then
        runs `steps` times, the first at a new key as the warm-up, every
        other as a replay of the graph of one step, and the call returns
        a copy of the last step's result."""
        if steps < 1:
            raise ValueError(f"steps={steps}: a graph runs at least once")
        full, unique = key_of(key, args, carry)
        g = self._graphs.get(full)
        if g is None:
            out = self._capture(full, key, body, args, carry, unique)
            g, todo = self.last, steps - 1
            if not todo:
                return out
        else:
            self._graphs.move_to_end(full)
            g.replays += 1
            todo = steps
        with span("graph.copy_in"):
            g.copy_in(unique, carry)
        with span("graph.replay"):
            for _ in range(todo):
                g.graph.replay()
        g.runs += todo
        for k, n in g.launches.items():
            COUNTED[k].LAUNCHES += n * todo
        return tree_map(torch.clone, g.outputs)

    def _capture(self, full, key, body, args, carry, unique):
        """The warm-up (one step on the caller's tensors, whose result it
        returns), then the capture on static copies, cached as `full`."""
        t0 = time.perf_counter()
        with span("graph.warmup"):
            out = self.backend.warm_up(body, (*args, *carry))
        warm_s = time.perf_counter() - t0
        made = {}

        def static(x):
            if id(x) not in made:
                s = x.detach().clone()
                made[id(x)] = s.requires_grad_(True) if x.requires_grad else s
            return made[id(x)]

        s_args = tree_map(static, args)
        s_carry = tuple(c.detach().clone() for c in carry)
        before = launch_counts()
        try:
            with span("graph.capture"):
                graph, outputs, times, pool = self.backend.capture(
                    body, (*s_args, *s_carry))
        finally:
            # the capture launched nothing: take its counts back
            grew = {k: n - before[k] for k, n in launch_counts().items()}
            for k, n in before.items():
                COUNTED[k].LAUNCHES = n
        g = Graph(key, graph, [made[id(t)] for t in unique],
                  [_stamp(t) for t in unique], s_carry, outputs,
                  {k: n for k, n in grew.items() if n},
                  dict(warmup_s=warm_s, **times), pool)
        self._graphs[full] = g
        self.captures += 1
        self.last = g
        while len(self._graphs) > self.max_graphs:
            self._graphs.popitem(last=False)
            self.backend.release()
        return out

    def clear(self):
        """Drop every graph and give their pools back to the card."""
        self._graphs.clear()
        self.last = None
        self.backend.release()


# the process's cache, which the entry points use
CACHE = GraphCache()
