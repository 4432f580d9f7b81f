"""Host-side structured tracing: named spans → Chrome trace JSON.

A copy of ``lstm_tensorspark_tpu/utils/tracing.py`` (the port imports
nothing of the JAX package): the host side of a run — data load, setup,
the train loop, eval, checkpoint, generation, and, through
``serve/batcher.py``, one admit→queue→prefill→decode→readback timeline per
request — saved in the Chrome trace-event format (chrome://tracing or
https://ui.perfetto.dev). ``serve --trace PATH`` and ``train --trace
PATH`` install a :class:`Tracer` and save it when the command ends.

Free when disabled: the module-level ``span``/``instant`` helpers do
nothing unless a Tracer is installed with ``set_tracer``.

Bounded when enabled: events live in a ring buffer (``max_events``,
default 200k); ``dropped`` counts what the ring displaced, and ``save``
records it in the trace.

Rows: events carry the full thread ident as ``tid``, and ``save`` emits
``thread_name`` metadata so each row shows the Python thread's name.
:meth:`Tracer.set_tid_name` names synthetic rows (one a request for the
serve timelines); :meth:`Tracer.complete` records a span from explicit
``time.perf_counter()`` stamps, how a request's phases are traced after
the fact.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque


class Tracer:
    """Collects trace events; thread-safe appends; ``save`` writes the
    Chrome trace-event JSON ({"traceEvents": [...]})."""

    def __init__(self, max_events: int = 200_000) -> None:
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = max_events
        self._events: deque[dict] = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._tid_names: dict[int, str] = {}
        self.dropped = 0

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _record(self, ev: dict) -> None:
        tid = ev["tid"]
        with self._lock:
            if tid not in self._tid_names:
                # only real threads auto-name; synthetic tids (requests)
                # are named explicitly via set_tid_name
                if tid == threading.get_ident():
                    self._tid_names[tid] = threading.current_thread().name
            if len(self._events) >= self.max_events:
                self.dropped += 1
            self._events.append(ev)

    def set_tid_name(self, tid: int, name: str) -> None:
        """Name a (possibly synthetic) ``tid`` row — emitted as a
        ``thread_name`` metadata event at :meth:`save`."""
        with self._lock:
            self._tid_names[int(tid)] = name

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Complete-event span ("ph": "X") around the with-block."""
        ts = self._now_us()
        try:
            yield self
        finally:
            dur = self._now_us() - ts
            ev = {"name": name, "ph": "X", "ts": ts, "dur": dur,
                  "pid": os.getpid(), "tid": threading.get_ident()}
            if args:
                ev["args"] = args
            self._record(ev)

    def complete(self, name: str, start_s: float, end_s: float, *,
                 tid: int | None = None, **args) -> None:
        """Record a complete event from explicit ``time.perf_counter()``
        stamps (taken while the phase ran, recorded later) — the serve
        batcher emits each finished request's phase timeline this way,
        one synthetic ``tid`` row per request."""
        ev = {"name": name, "ph": "X",
              "ts": (start_s - self._t0) * 1e6,
              "dur": max((end_s - start_s) * 1e6, 0.0),
              "pid": os.getpid(),
              "tid": threading.get_ident() if tid is None else int(tid)}
        if args:
            ev["args"] = args
        self._record(ev)

    def instant(self, name: str, **args) -> None:
        ev = {"name": name, "ph": "i", "ts": self._now_us(), "s": "g",
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._record(ev)

    def save(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with self._lock:
            events = list(self._events)
            names = dict(self._tid_names)
            dropped = self.dropped
        pid = os.getpid()
        meta = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": name}}
            for tid, name in sorted(names.items())
        ]
        if dropped:
            meta.append({
                # tid -1: a sentinel row no real thread or synthetic
                # request id can own (request rows use non-negative ids)
                "name": "tracer_dropped_events", "ph": "i", "ts": 0.0,
                "s": "g", "pid": pid, "tid": -1,
                "args": {"dropped": dropped, "max_events": self.max_events},
            })
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + events,
                       "displayTimeUnit": "ms"}, f)


_tracer: Tracer | None = None


def set_tracer(tracer: Tracer | None) -> None:
    global _tracer
    _tracer = tracer


def get_tracer() -> Tracer | None:
    return _tracer


@contextlib.contextmanager
def span(name: str, **args):
    """Module-level span: records on the installed tracer, no-op otherwise."""
    t = _tracer
    if t is None:
        yield None
    else:
        with t.span(name, **args):
            yield t


def instant(name: str, **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, **args)
