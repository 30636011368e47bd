"""Compiled entry points: the port's counterpart of `jax.jit` at the JAX
package's jitted entry points (`render_pixels`, whose 16-spp frame is one
XLA program; `fit`'s step on every scene, both `custom_vjp` modes and
`mesh=`; the CLI's `benchmark --occupancy` frame; the sharded frame of
`render_image_multihost`; `bench.py`'s `jax.jit(frame)` and
`jax.jit(gsum)`), as CUDA graphs.

A `GraphCache` maps a key to a captured graph. The first call with a new
key runs the body eagerly on a side stream (the warm-up: on first use it
also builds the kernels with nvcc and fills the launchers' per-process
memos, the occupancy queries and shared-memory attributes), returns that
result, and then captures the body once more as a CUDA graph on the same
side stream (`torch.cuda.CUDAGraph`, a private memory pool of its own,
global capture mode). Every later call with that key copies its inputs
into the graph's static input buffers, replays the graph on the current
stream and returns a copy of the static outputs, which the next replay
overwrites. So an entry point replays from its second call on.

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
  (`dist.sharding.train_step`, a one-shot step on new leaves at every
  call, runs eagerly: a graph keyed on them would never replay.)
- **The key.** The entry point's name, its static arguments (the config,
  width, height, samples, first sample: what JAX marks static), and the
  `signature` of every tensor the body reads: shape, dtype, strides,
  device, `requires_grad` and `data_ptr`. A graph reads its inputs where
  they lay at capture, so the entry keeps a reference to them (`keep`):
  their memory cannot be handed to another tensor while the graph lives,
  and a value written in place (Adam's update of a parameter) is what the
  next replay reads. Tensors copied into static buffers (pixel ids) enter
  by shape and dtype only. The host reads of a frame
  (`integrator.host_constants`: `dark_sky`, an image sky's size) are
  baked into the kernels' arguments, so their values are in the key: a
  new `dark_sky` value (it has a gradient, though no `train.py` field
  trains it) is a new key.
- **The seed.** The port hashes the seed into the ray keys on the host
  (`core/rng.py::ray_keys`), so the seed is in the key: a new seed costs
  a capture, where JAX traces `base_key` and compiles once.
- **Launch counts.** A kernel wrapper adds one to its module's `LAUNCHES`
  where it launches; a replay runs no wrapper. The cache records each
  counter's increase during the capture (which launches nothing), takes it
  back, and adds it again at every replay, so the counts still say which
  kernels ran how often.
- **A failed capture raises** the body's error (a read of the card inside
  the body is refused by the capture); nothing is cached and there is no
  eager fallback.
- **Size.** At most `max_graphs` graphs (8 by default), least recently
  used first out; an evicted graph's pool goes back to the card. A
  16-spp protocol step's pool holds about what the step's peak does
  (3.8-4.4 GB on 850x480, PERF.md section 5), a frame's about a tenth.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from dataclasses import fields, is_dataclass
from typing import Callable, Optional

import torch

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
               shadow=kshadow, row_sum=krowsum)


def launch_counts() -> dict:
    return {k: m.LAUNCHES for k, m in COUNTED.items()}


def signature(x):
    """A hashable description of `x` for a graph's key: a tensor by shape,
    dtype, strides, device, `requires_grad` and `data_ptr`; dataclasses,
    dicts, tuples and lists by their parts; anything else as it is (it
    must be hashable: ints, floats, strings, None)."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.stride(), str(x.device),
                x.requires_grad, x.data_ptr())
    if is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, signature(getattr(x, f.name))) for f in fields(x))
    if isinstance(x, dict):
        return tuple((k, signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (tuple, list)):
        return tuple(signature(v) for v in x)
    hash(x)
    return x


def meta(t: torch.Tensor):
    """The key of an input copied into a static buffer: its shape, dtype
    and device, not its address."""
    return ("input", tuple(t.shape), t.dtype, str(t.device))


def _tree_map(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


class Graph:
    """One captured body: the graph, its static inputs and outputs, the
    launches a replay stands for, what it keeps alive, and what its
    capture cost (seconds of the warm-up, the capture and the
    instantiation; the bytes its pool reserved)."""

    def __init__(self, key, graph, inputs, outputs, launches, keep, times,
                 pool_bytes):
        self.key, self.graph = key, graph
        self.inputs, self.outputs = inputs, outputs
        self.launches, self.keep = launches, keep
        self.times, self.pool_bytes = times, pool_bytes
        self.replays = 0


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
        _tree_map(lambda t: t.record_stream(cur), out)
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
        return key in self._graphs

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

    def call(self, key, body: Callable, inputs=(), keep=()):
        """`body(*inputs)`, a pytree of tensors, by the graph of `key`:
        replayed if cached, else the warm-up's result, with the body then
        captured on static copies of `inputs`. `keep`: what the body reads
        besides `inputs` (held while the graph lives)."""
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
            for s, x in zip(g.inputs, inputs):
                s.copy_(x)
            g.graph.replay()
            for k, n in g.launches.items():
                COUNTED[k].LAUNCHES += n
            g.replays += 1
            return _tree_map(torch.clone, g.outputs)
        t0 = time.perf_counter()
        out = self.backend.warm_up(body, inputs)
        warm_s = time.perf_counter() - t0
        statics = [x.clone() for x in inputs]
        before = launch_counts()
        try:
            graph, outputs, times, pool = self.backend.capture(body, statics)
        finally:
            # the capture launched nothing: take its counts back
            grew = {k: n - before[k] for k, n in launch_counts().items()}
            for k, n in before.items():
                COUNTED[k].LAUNCHES = n
        g = Graph(key, graph, statics, outputs,
                  {k: n for k, n in grew.items() if n}, keep,
                  dict(warmup_s=warm_s, **times), pool)
        self._graphs[key] = g
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
