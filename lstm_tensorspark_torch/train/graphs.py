"""Train calls captured as CUDA graphs and replayed: the port's ``jax.jit``.

Port of the compile-and-cache role of
``lstm_tensorspark_tpu/train/device_step.py::_jit_step`` and
``TrainStepCompileCache``. Every train call on the card — one step or K
steps, host-fed or fed from data staged on the device, with the eval fused
in or not — is the body of a builder (``train/loop.py``,
``train/multistep.py``, ``train/device_step.py``) wrapped by
:func:`graphed`. On the card the body is captured once and each call
replays it; on the CPU, or with ``graph=False``, the body runs eagerly.

A body is ``body(state, feed, do_eval) -> (state, metrics)``: ``feed`` is
a dict of the call's own tensors (the batch, a window index, [K, B]
example indices), ``do_eval`` whether the fused eval runs. What stays on
the device from call to call (staged data, eval data, eval carries) the
builder binds into the body when it is made; a graph reads it where it
lies.

How a capture keeps the eager semantics:

- **Static buffers.** The graph reads the train state and the feed from
  buffers of its own and writes the new state back into the state buffers
  at its end. Before each replay the host copies the call's feed into the
  feed buffers. The state a call returns holds those buffers: the next call
  updates them in place (as a donated state would be), and a state that is
  not the one returned last is copied in first. ``metrics`` are the
  graph's output tensors, valid until the next call.
- **Graphs by key.** A graph is kept per feed signature (names, shapes and
  dtypes) and ``do_eval``; a call with the eval fused in
  and one without are two graphs, and the host picks one (JAX's
  ``lax.cond`` on ``do_eval``). A fused step captures both at its first
  call. Each capture is logged (``note: graph capture``, with ``mid_run``
  set when calls came before it).
- **Warm-up does not train.** Before a capture the body runs
  :data:`WARMUP_CALLS` times eagerly on a side stream, on a clone of the
  state (lazy initialisation, and the kernels' first-use builds, must not
  happen inside a capture). The warm-up records the dropout generators
  the body draws from (``ops/masking.track_generators``); their states
  are restored after the warm-up and after the capture, and each is
  registered with the graph, so replay n draws the Philox offsets, in the
  same order, that eager call n would.
- **Launch counts.** A kernel wrapper bumps its counter on the host, which
  happens at capture and never at replay. The capture's bumps are
  recorded per counter (and taken back: a capture launches nothing), and
  each replay adds them again. The warm-up calls are real launches and
  count as such.
- **No fallback.** A capture or replay that fails raises with the route
  and the feed's shapes; nothing carries on eagerly.
"""

from __future__ import annotations

import ctypes
import time
from typing import Any, Callable, NamedTuple

import torch

from .. import kernels
from ..ops.masking import track_generators
from .loop import TrainState, param_leaves, params_from_leaves

# eager calls on a clone of the state before each capture
WARMUP_CALLS = 1

Body = Callable[[TrainState, dict, bool], tuple]


def state_leaves(state: TrainState) -> list[torch.Tensor]:
    """The state's tensors in a fixed order: params (:func:`param_leaves`),
    the optimizer state by key, then the carries."""
    out = list(param_leaves(state.params))
    for k in sorted(state.opt_state):
        v = state.opt_state[k]
        out += list(v) if isinstance(v, list) else [v]
    for h, c in state.carries or ():
        out += [h, c]
    return out


def state_from_leaves(like: TrainState, leaves) -> TrainState:
    """Inverse of :func:`state_leaves` for a state shaped like ``like``."""
    it = iter(leaves)
    n = len(param_leaves(like.params))
    params = params_from_leaves(like.params, [next(it) for _ in range(n)])
    opt = {}
    for k in sorted(like.opt_state):
        v = like.opt_state[k]
        opt[k] = [next(it) for _ in v] if isinstance(v, list) else next(it)
    carries = (None if like.carries is None
               else [(next(it), next(it)) for _ in like.carries])
    return TrainState(like.step, params, opt, carries)


def _captured_nodes() -> int | None:
    """The node count of the graph being captured on the current stream
    (``cuStreamGetCaptureInfo`` and ``cuGraphGetNodes`` of ``libcuda``),
    or None where that library does not answer."""
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
        info = cuda.cuStreamGetCaptureInfo_v2
        nodes = cuda.cuGraphGetNodes
    except (OSError, AttributeError):
        return None
    status, gid = ctypes.c_int(0), ctypes.c_ulonglong(0)
    graph, deps, ndeps = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if info(stream, ctypes.byref(status), ctypes.byref(gid),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(ndeps)):
        return None
    n = ctypes.c_size_t(0)
    if status.value != 1 or nodes(graph, None, ctypes.byref(n)):
        return None
    return n.value


class _Graph(NamedTuple):
    graph: Any  # torch.cuda.CUDAGraph
    metrics: dict
    launches: tuple  # ((LaunchCounts, launches a replay), ...)
    steps: int  # optimizer steps a replay takes


def _register(graph, gen, route: str) -> None:
    if not hasattr(graph, "register_generator_state"):
        raise RuntimeError(
            f"{route}: PyTorch {torch.__version__} cannot register a dropout "
            "generator with a CUDA graph; its replays would repeat the "
            "masks of the capture")
    graph.register_generator_state(gen)


class GraphedCall:
    """Capture-and-replay of one builder's body on the card (see the
    module docstring). ``route`` names the builder in errors and capture
    records; ``fused`` captures both ``do_eval`` variants at the first
    call; ``log`` receives one record per capture."""

    def __init__(self, body: Body, *, route: str, fused: bool = False,
                 log: Callable[[dict], None] | None = None):
        self._body = body
        self.route = route
        self._fused = fused
        self._log = log
        self._graphs: dict = {}
        self._feeds: dict = {}
        self._static: TrainState | None = None
        self._static_leaves: list[torch.Tensor] = []
        self.calls = 0

    def _adopt(self, state: TrainState) -> None:
        """Make the static state hold ``state``'s values."""
        s = self._static
        if s is None:
            self._static_leaves = [t.detach().clone()
                                   for t in state_leaves(state)]
            self._static = state_from_leaves(state, self._static_leaves)
        elif (state.params is not s.params or state.opt_state is not
              s.opt_state or state.carries is not s.carries):
            for dst, src in zip(self._static_leaves, state_leaves(state)):
                dst.copy_(src, non_blocking=True)

    def _fill(self, feed_sig, feed: dict) -> dict:
        bufs = self._feeds.get(feed_sig)
        if bufs is None:
            dev = self._static_leaves[0].device
            bufs = self._feeds[feed_sig] = {
                k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                for k, v in feed.items()}
        for k, v in feed.items():
            if v.device.type == "cpu":
                v = v.pin_memory()
            bufs[k].copy_(v, non_blocking=True)
        return bufs

    def _describe(self, feed: dict, do_eval: bool) -> str:
        shapes = {k: tuple(v.shape) for k, v in feed.items()}
        return f"{self.route} (feed {shapes}, do_eval={do_eval})"

    def _capture(self, feeds: dict, do_eval: bool) -> _Graph:
        dev = self._static_leaves[0].device
        what = self._describe(feeds, do_eval)
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side), track_generators() as drawn:
            clone = state_from_leaves(
                self._static, [t.clone() for t in self._static_leaves])
            for _ in range(WARMUP_CALLS):
                clone, _ = self._body(clone, feeds, do_eval)
        cur.wait_stream(side)
        torch.cuda.synchronize(dev)  # a warm-up fault surfaces here
        del clone
        for g, s in drawn.items():
            g.set_state(s)
        warm_ms = (time.perf_counter() - t0) * 1e3
        graph = torch.cuda.CUDAGraph()
        for gen in drawn:
            _register(graph, gen, self.route)
        counters = kernels.LaunchCounts.every()
        before = [c.kernel for c in counters]
        t1 = time.perf_counter()
        with kernels.CAPTURE_LOCK:
            try:
                with torch.cuda.graph(graph):
                    out, metrics = self._body(self._static, feeds, do_eval)
                    for dst, src in zip(self._static_leaves,
                                        state_leaves(out)):
                        if dst is not src:
                            dst.copy_(src)
                    nodes = _captured_nodes()
            except Exception as e:
                raise RuntimeError(
                    f"CUDA graph capture of {what} failed: {e}") from e
        capture_ms = (time.perf_counter() - t1) * 1e3
        launches = []
        for c, n0 in zip(counters, before):
            n = c.kernel - n0
            if n:
                c.add("kernel", -n)  # the capture launched nothing
                launches.append((c, n))
        for g, s in drawn.items():
            g.set_state(s)
        steps = out.step - self._static.step
        record = {"note": "graph capture", "route": self.route,
                  "do_eval": do_eval,
                  "feed": {k: list(v.shape) for k, v in feeds.items()},
                  "steps": steps, "warmup_calls": WARMUP_CALLS,
                  "warmup_ms": warm_ms, "capture_ms": capture_ms,
                  "nodes": nodes,
                  "launches": {c.name: n for c, n in launches},
                  "generators": len(drawn),
                  "mid_run": self.calls > 0}
        if self._log is not None:
            self._log(record)
        return _Graph(graph, metrics, tuple(launches), steps)

    def __call__(self, state: TrainState, feed: dict, do_eval: bool = False):
        feed_sig = tuple((k, tuple(v.shape), v.dtype) for k, v in feed.items())
        g = self._graphs.get((feed_sig, do_eval))
        self._adopt(state)
        feeds = self._fill(feed_sig, feed)
        if g is None:
            for variant in ((do_eval, not do_eval) if self._fused
                            else (do_eval,)):
                self._graphs[feed_sig, variant] = self._capture(feeds,
                                                                variant)
            g = self._graphs[feed_sig, do_eval]
        try:
            g.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph replay of "
                               f"{self._describe(feed, do_eval)} failed: "
                               f"{e}") from e
        for c, n in g.launches:
            c.add("kernel", n)
        self.calls += 1
        return self._static._replace(step=state.step + g.steps), g.metrics


def graphed(body: Body, *, route: str, graph: bool = True,
            fused: bool = False, log: Callable[[dict], None] | None = None):
    """``run(state, feed, do_eval=False) -> (state, metrics)`` over
    ``body``: replayed from a captured CUDA graph (a
    :class:`GraphedCall`, made at the first call) when the state lies on
    the card and ``graph`` is set; else ``body`` itself, with the feed
    moved to the state's device. ``graph=False`` is the eager form the
    tests and the card's comparisons use (JAX's ``jit=False``)."""
    holder: list[GraphedCall] = []  # made at the first call on the card

    def run(state: TrainState, feed: dict, do_eval: bool = False):
        dev = state.opt_state["count"].device
        if graph and dev.type == "cuda":
            if not holder:
                holder.append(GraphedCall(body, route=route, fused=fused,
                                          log=log))
            return holder[0](state, feed, bool(do_eval))
        return body(state, {k: v.to(dev) for k, v in feed.items()},
                    bool(do_eval))

    return run
