"""Serving front-ends: in-process client and a stdlib HTTP server.

Port of the one-replica path of ``lstm_tensorspark_tpu/serve/server.py``.
:class:`ServeServer` owns one replica (an engine, a :class:`Batcher` and
the scheduler thread) behind the admission :class:`~.router.Router`, as
the JAX server does for every stack; :meth:`ServeServer.generate` is the
synchronous request path both front-ends use:

- :class:`InprocessClient` — the same admission, batching and backpressure
  semantics as HTTP, without sockets;
- :func:`make_http_server` — a ``ThreadingHTTPServer`` JSON endpoint:

  - ``POST /v1/generate`` body ``{"prompt": [ids], "max_new_tokens": N,
    "greedy": bool, "temperature": t, "top_k": k, "top_p": p,
    "eos_id": id, "timeout": s,
    "session_id": str, "keep_session": bool, "use_prefix": bool,
    "class": "priority" | "best_effort", "deadline_s": s, "tenant": str,
    "request_id": str}`` →
    ``{"tokens": [...], "session_id": ..., "replica": 0, "class": ...,
    "latency_ms": ..., "ttft_ms": ..., "max_itl_ms": ..., "phases_ms":
    {...}}``. ``keep_session`` keeps the session's state after the
    request and returns its id; a later request naming that
    ``session_id`` continues it (its prompt is the next fragment). The
    deadline may come as the ``X-Deadline-S`` header instead; without
    either the class's default applies (``deadline_defaults``), and an
    explicit ``deadline_s <= 0`` opts out of it. A ``request_id`` makes
    a retried delivery replay the settled reply instead of decoding
    twice;
  - ``GET /healthz`` → scheduler liveness (200 ``ok``, 503 ``down``);
  - ``GET /v1/stats`` (alias ``/stats``) → engine, cache, prefix-cache,
    tier, batcher and router counters, and ``metrics``: the registry's
    histogram summaries (p50/p99) and counter values;
  - ``GET /metrics`` → the registry as Prometheus text (format 0.0.4):
    server-side TTFT, inter-token gaps, queue wait, scheduler iteration
    time, readback latency, outcomes, sheds, cache and tier counters.

Every non-200 reply has one shape: ``{"error": message, "code": token,
"retryable": bool, "retry_after_s": s or null}``. A shed is 429
``queue_full`` with the ``Retry-After`` header (whole seconds, rounded
up); a deadline is 504 ``deadline_exceeded`` carrying the partial
``tokens``; a bad body, a reserved ``session_id`` or a sampling config
JAX's sampler refuses (``top_k < 1``, ``top_p`` outside (0, 1]) 400
``bad_request``; a scheduler-side
failure (an unknown or busy session) 500 ``internal``; a client-side wait
past ``timeout`` 504 ``client_timeout``; an unknown route 404
``not_found``. ``GET`` and ``POST /rollout`` answer 404 ``not_found`` too:
the rollout controller JAX's server attaches with a model registry is not
ported (the port's ``--registry-dir`` serves the speculative draft alone).

:meth:`ServeServer.stop` flushes the engine's tiers, so a clean stop lands
every kept session's checkpoint on the disk tier.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .batcher import (CLASSES, Batcher, DeadlineExceededError,
                      QueueFullError, Request)
from .engine import GREEDY, SamplingParams, ServeEngine
from .router import Replica, Router

#: a scheduler whose heartbeat is older than this is reported down (and
#: its queue no longer counts against the router's bound)
STALE_HEARTBEAT_S = 30.0
_NO_ROLLOUT = ("no rollout controller: the rollout controller "
               "(serve/rollout.py) is not ported; --registry-dir serves the "
               "speculative draft alone")


class SettledCache:
    """Settled replies by client-minted ``request_id`` (a copy of the JAX
    package's ``serve/transport.SettledCache``). ``begin(rid)`` returns
    ``("mine", None)`` for a first delivery (the caller then ``settle``s
    or ``abandon``s it), ``("hit", (status, payload))`` for a replay of a
    settled one, and ``("timeout", None)`` when a concurrent first
    delivery still runs past ``wait_timeout``. Only replies that decoded
    tokens are settled (200 and 504 ``deadline_exceeded``). A bounded LRU
    with a TTL; in-flight ids are never evicted."""

    def __init__(self, *, max_entries: int = 1024, ttl_s: float = 600.0,
                 registry=None):
        self.max_entries = int(max_entries)
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._settled: OrderedDict[str, tuple[int, dict, float]] = \
            OrderedDict()
        self._inflight: dict[str, threading.Event] = {}
        self.hits = 0
        self.waits = 0
        self.stores = 0
        self._m_dedup = None
        if registry is not None:
            self._m_dedup = registry.counter(
                "serve_replay_dedup_total",
                "generate replay dedup events by result",
                labelnames=("result",))

    def _count(self, result: str) -> None:
        if self._m_dedup is not None:
            self._m_dedup.labels(result=result).inc()

    def begin(self, rid: str, wait_timeout: float | None = None):
        waited = False
        while True:
            with self._lock:
                entry = self._settled.get(rid)
                if entry is not None:
                    self._settled.move_to_end(rid)
                    self.hits += 1
                    hit = (entry[0], entry[1])
                else:
                    event = self._inflight.get(rid)
                    if event is None:
                        self._inflight[rid] = threading.Event()
                        return ("mine", None)
                    hit = None
            if hit is not None:
                self._count("hit")
                return ("hit", hit)
            if not waited:
                waited = True
                self.waits += 1
                self._count("wait")
            if not event.wait(wait_timeout):
                return ("timeout", None)
            # settled (replay it) or abandoned (it becomes ours)

    def settle(self, rid: str, status: int, payload: dict) -> None:
        now = time.monotonic()
        with self._lock:
            event = self._inflight.pop(rid, None)
            self._settled[rid] = (int(status), payload, now)
            self._settled.move_to_end(rid)
            self.stores += 1
            while len(self._settled) > self.max_entries:
                self._settled.popitem(last=False)
            cutoff = now - self.ttl_s
            for k in [k for k, (_, _, t) in self._settled.items()
                      if t < cutoff]:
                del self._settled[k]
        self._count("store")
        if event is not None:
            event.set()

    def abandon(self, rid: str) -> None:
        with self._lock:
            event = self._inflight.pop(rid, None)
        if event is not None:
            event.set()

    def stats(self) -> dict:
        with self._lock:
            return {"settled": len(self._settled),
                    "inflight": len(self._inflight),
                    "hits": self.hits, "waits": self.waits,
                    "stores": self.stores}


class ServeServer:
    """One replica (engine, batcher, scheduler thread) behind the
    admission router. Use as a context manager, or call
    :meth:`start`/:meth:`stop`.

    ``queue_size`` is the admission bound (the router's, and the
    batcher's own); ``best_effort_queue_frac`` the share of it at which
    ``best_effort`` is shed; ``class_weights`` the weighted dequeue
    (priority, best_effort); ``deadline_defaults`` ``{class: seconds}``
    applied when a request names no deadline (0 or None: no default);
    ``tenant_rate`` / ``tenant_burst`` the router's per-tenant token
    bucket (off by default); ``prefill_chunk_choices`` the warmed chunk
    sizes the autotuner may move ``prefill_chunk`` among; ``autotune`` an
    :class:`~.autotune.AutoTuneConfig` to run the online autotuner (its
    thread started by :meth:`start` and joined by :meth:`stop`; None, the
    default, moves no knob)."""

    def __init__(self, engine: ServeEngine, *, max_active: int = 16,
                 queue_size: int = 64,
                 window_ladder: tuple[int, ...] = Batcher.DEFAULT_WINDOW_LADDER,
                 prefill_chunk: int | None = None,
                 prefill_chunk_choices: tuple[int, ...] | None = None,
                 class_weights: tuple[int, int] = Batcher.DEFAULT_CLASS_WEIGHTS,
                 speculative: bool = False,
                 spec_ladder: tuple[int, ...] = Batcher.DEFAULT_SPEC_LADDER,
                 spec_k: int | None = None,
                 best_effort_queue_frac: float = 0.5,
                 deadline_defaults: dict | None = None,
                 tenant_rate: float | None = None,
                 tenant_burst: float = 5.0,
                 autotune=None):
        if isinstance(engine, (list, tuple)):
            if len(engine) != 1:
                raise ValueError(
                    f"the port serves one replica; got {len(engine)} "
                    "engines (multi-replica serving is not ported)")
            engine = engine[0]
        self.deadline_defaults = {c: None for c in CLASSES}
        for c, v in (deadline_defaults or {}).items():
            if c not in CLASSES:
                raise ValueError(f"unknown admission class {c!r}")
            if v is not None and v < 0:
                raise ValueError(
                    f"deadline_defaults[{c!r}] must be >= 0 or None, "
                    f"got {v}")
            # 0 means no default (the CLI's convention), normalised here
            # so no request of the class fails validation later
            self.deadline_defaults[c] = v if v else None
        batcher = Batcher(engine, max_active=max_active,
                          queue_size=queue_size,
                          window_ladder=window_ladder,
                          prefill_chunk=prefill_chunk,
                          prefill_chunk_choices=prefill_chunk_choices,
                          class_weights=class_weights,
                          speculative=speculative,
                          spec_ladder=spec_ladder, spec_k=spec_k)
        self.replicas = [Replica(0, engine, batcher)]
        self.router = Router(
            self.replicas, queue_size=queue_size,
            stale_after=STALE_HEARTBEAT_S,
            best_effort_frac=best_effort_queue_frac,
            registry=engine.metrics,
            tenant_rate=tenant_rate, tenant_burst=tenant_burst)
        self.settled = SettledCache(registry=engine.metrics)
        self._model_info_seen: set[tuple[str, str]] = set()
        self._stop = threading.Event()
        # built over the finished stack, so it sees the batcher, the tiers
        # and the router
        self.autotuner = None
        if autotune is not None:
            from .autotune import AutoTuner

            self.autotuner = AutoTuner(self, autotune)

    @property
    def engine(self) -> ServeEngine:
        return self.replicas[0].engine

    @property
    def batcher(self) -> Batcher:
        return self.replicas[0].batcher

    @property
    def _thread(self) -> threading.Thread | None:
        return self.replicas[0].thread

    @property
    def device(self):
        return self.engine.device

    def start(self) -> "ServeServer":
        rep = self.replicas[0]
        if rep.thread is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        rep.retired = False
        rep.thread = threading.Thread(target=rep.batcher.run,
                                      args=(self._stop,),
                                      name="serve-scheduler", daemon=True)
        rep.thread.start()
        # arm the death sweep only once the thread runs
        self.router.set_stopping(False)
        if self.autotuner is not None:
            self.autotuner.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        # the controller parks first: no knob moves while the scheduler is
        # joined
        if self.autotuner is not None:
            self.autotuner.stop()
        # disarm the sweep first: a joined thread is not a dead one
        self.router.set_stopping(True)
        self._stop.set()
        rep = self.replicas[0]
        if rep.thread is not None:
            rep.thread.join(timeout)
            if rep.thread.is_alive():
                raise RuntimeError("scheduler thread did not stop")
            rep.thread = None
        tiers = self.engine.tiers
        if tiers is not None:
            # the durability barrier: every kept session's write-behind
            # checkpoint lands before stop returns; then park the worker
            tiers.flush(timeout=10.0)
            tiers.close()

    def __enter__(self) -> "ServeServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def warmup(self, sampling: SamplingParams = GREEDY,
               prompt_lens: tuple[int, ...] = (1,)) -> int:
        return self.batcher.warmup(sampling, prompt_lens=prompt_lens)

    def generate(self, prompt, *, max_new_tokens: int,
                 sampling: SamplingParams = GREEDY, eos_id: int | None = None,
                 session_id: str | None = None, keep_session: bool = False,
                 use_prefix: bool = True,
                 timeout: float = 120.0,
                 klass: str = "priority",
                 deadline_s: float | None = None,
                 tenant: str | None = None) -> Request:
        """Submit through the router and block until done; returns the
        filled :class:`Request` (``.tokens``, ``.session_id``,
        timestamps). Raises ``ValueError`` (a request the engine will not
        serve), :class:`QueueFullError` (a shed, with ``retry_after_s``),
        :class:`DeadlineExceededError` (the server-side deadline lapsed;
        ``.request`` holds the partial output), ``TimeoutError`` (the
        client-side wait; the request is then cancelled), or
        ``RuntimeError`` on a scheduler failure (an unknown or busy
        session among them). ``deadline_s`` defaults to the class's
        default; an explicit ``deadline_s <= 0`` opts out of it."""
        if deadline_s is None:
            deadline_s = self.deadline_defaults.get(klass)
        elif deadline_s <= 0:
            deadline_s = None
        req = Request(prompt, max_new_tokens, sampling=sampling, eos_id=eos_id,
                      session_id=session_id, keep_session=keep_session,
                      use_prefix=use_prefix, klass=klass,
                      deadline_s=deadline_s, tenant=tenant)
        self.router.submit(req)
        if not req.done.wait(timeout):
            req.cancelled = True
            raise TimeoutError(f"request {req.id} not completed within "
                               f"{timeout:.0f}s")
        if req.timed_out:
            raise DeadlineExceededError(req)
        if req.error is not None:
            raise RuntimeError(req.error)
        return req

    def stats(self) -> dict:
        return {"engine": self.engine.stats(), "batcher": self.batcher.stats(),
                "router": self.router.stats(),
                "metrics": self.metrics_summary(),
                # the controller's decisions and last window; None = off
                "autotune": (None if self.autotuner is None
                             else self.autotuner.stats())}

    def _collect_gauges(self) -> None:
        """Refresh the poll-style gauges at scrape time (an idle scheduler
        may not have stepped since the last change)."""
        reg = self.engine.metrics
        live = dead = 0
        for r in self.replicas:
            rl = str(r.index)
            b = r.batcher.stats()
            reg.gauge("serve_queue_depth", labelnames=("replica",)).labels(
                replica=rl).set(b["queued"])
            reg.gauge("serve_active_sessions",
                      labelnames=("replica",)).labels(
                replica=rl).set(b["active"])
            reg.gauge("serve_prefilling_sessions",
                      labelnames=("replica",)).labels(
                replica=rl).set(b["prefilling"])
            c = r.engine.cache.stats()
            fam = reg.gauge("serve_state_cache_slots",
                            "state-cache slot occupancy",
                            labelnames=("replica", "state"))
            fam.labels(replica=rl, state="live").set(c["live_sessions"])
            fam.labels(replica=rl, state="pinned").set(c["pinned"])
            fam.labels(replica=rl, state="free").set(c["free"])
            if r.engine.prefix is not None:
                reg.gauge("serve_prefix_cache_entries",
                          "live prefix-cache entries",
                          labelnames=("replica",)).labels(replica=rl).set(
                    r.engine.prefix.stats()["entries"])
            if r.engine.tiers is not None:
                ts = r.engine.tiers.stats()
                fam = reg.gauge("serve_tier_entries",
                                "spilled session states held per tier "
                                "(pending = spill captured, fetch not "
                                "done)",
                                labelnames=("tier", "replica"))
                for tier in ("pending", "host", "disk"):
                    fam.labels(tier=tier, replica=rl).set(
                        ts["entries"][tier])
            if r.alive():
                live += 1
            else:
                dead += 1
        fam = reg.gauge("serve_replicas",
                        "replica schedulers by liveness state",
                        labelnames=("state",))
        fam.labels(state="live").set(live)
        fam.labels(state="dead").set(dead)
        fam = reg.gauge(
            "serve_model_info",
            "replicas hosting each resident model version (two versions "
            "of one model nonzero at once outside a rollout = version "
            "skew; see docs/OPERATIONS.md)",
            labelnames=("model", "version"))
        current: dict[tuple[str, str], int] = {}
        for r in self.replicas:
            for mid, ver in r.engine.resident_models().items():
                key = (mid, str(ver))
                current[key] = current.get(key, 0) + 1
        for key in self._model_info_seen - set(current):
            fam.labels(model=key[0], version=key[1]).set(0)
        for (mid, ver), count in current.items():
            fam.labels(model=mid, version=ver).set(count)
        self._model_info_seen |= set(current)

    def metrics_text(self) -> str:
        """Prometheus text exposition of the stack's registry (``GET
        /metrics``)."""
        self._collect_gauges()
        return self.engine.metrics.render_prometheus()

    def metrics_summary(self) -> dict:
        """JSON-ready registry view (histograms as {count, sum, p50,
        p99}; ``replica``-labelled families also under the bare name)."""
        self._collect_gauges()
        return self.engine.metrics.summaries()

    def health(self) -> dict:
        self.router.sweep()
        thread = self._thread
        alive = thread is not None and thread.is_alive()
        beat = self.batcher.last_heartbeat
        age = None if beat is None else time.monotonic() - beat
        ok = alive and (age is None or age < STALE_HEARTBEAT_S)
        return {"status": "ok" if ok else "down", "scheduler_alive": alive,
                "heartbeat_age_s": age, "device": str(self.engine.device)}


class InprocessClient:
    """Synchronous in-process client: the HTTP semantics without sockets."""

    def __init__(self, server: ServeServer):
        self._server = server

    def generate(self, prompt, *, max_new_tokens: int,
                 sampling: SamplingParams = GREEDY, **kw) -> list[int]:
        req = self._server.generate(prompt, max_new_tokens=max_new_tokens,
                                    sampling=sampling, **kw)
        return list(req.tokens)

    def stats(self) -> dict:
        return self._server.stats()


def sampling_from_body(body: dict) -> SamplingParams:
    """Sampling config of a request body. Temperature and top-p are
    rounded to 2 decimals so near-equal floats share one config."""
    top_k = body.get("top_k")
    top_p = body.get("top_p")
    return SamplingParams(
        temperature=round(float(body.get("temperature", 1.0)), 2),
        top_k=None if top_k is None else int(top_k),
        top_p=None if top_p is None else round(float(top_p), 2),
        greedy=bool(body.get("greedy", False)),
    )


def error_parts(code: str, message: str, *, retryable: bool,
                retry_after_s: float | None = None,
                **extra) -> tuple[dict, dict | None]:
    """The one body shape of every non-200 reply, and its headers: a 429
    with a retry estimate also sends ``Retry-After`` in whole seconds,
    rounded up (at least 1; the body keeps the float)."""
    body = {"error": message, "code": code, "retryable": bool(retryable),
            "retry_after_s": retry_after_s, **extra}
    headers = None
    if retry_after_s is not None:
        headers = {"Retry-After": str(max(1, int(-(-retry_after_s // 1))))}
    return body, headers


class _Handler(BaseHTTPRequestHandler):
    server_version = "lstm-tsp-torch-serve/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # no per-request stderr lines
        pass

    @property
    def _serve(self) -> ServeServer:
        return self.server.serve  # type: ignore[attr-defined]

    def _reply(self, code: int, payload: dict,
               headers: dict | None = None) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _error(self, status: int, code: str, message: str, *,
               retryable: bool, retry_after_s: float | None = None,
               **extra) -> None:
        body, headers = error_parts(code, message, retryable=retryable,
                                    retry_after_s=retry_after_s, **extra)
        self._reply(status, body, headers)

    def do_GET(self) -> None:
        if self.path == "/healthz":
            health = self._serve.health()
            self._reply(200 if health["status"] == "ok" else 503, health)
        elif self.path in ("/v1/stats", "/stats"):
            self._reply(200, self._serve.stats())
        elif self.path == "/metrics":
            data = self._serve.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif self.path == "/rollout":
            self._error(404, "not_found", _NO_ROLLOUT, retryable=False)
        else:
            self._error(404, "not_found", f"no route {self.path}",
                        retryable=False)

    def do_POST(self) -> None:
        if self.path == "/rollout":
            self._error(404, "not_found", _NO_ROLLOUT, retryable=False)
            return
        if self.path != "/v1/generate":
            self._error(404, "not_found", f"no route {self.path}",
                        retryable=False)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            prompt = body["prompt"]
            max_new = int(body.get("max_new_tokens", 16))
            sampling = sampling_from_body(body)
            timeout = float(body.get("timeout", 120.0))
            eos_id = body.get("eos_id")
            eos_id = None if eos_id is None else int(eos_id)
            session_id = body.get("session_id")
            if session_id is not None and not isinstance(session_id, str):
                raise ValueError("session_id must be a string")
            keep_session = bool(body.get("keep_session", False))
            use_prefix = bool(body.get("use_prefix", True))
            # the body's deadline wins; X-Deadline-S is the proxy-friendly
            # form; neither: the class's default
            deadline_s = body.get("deadline_s")
            if deadline_s is None:
                hdr = self.headers.get("X-Deadline-S")
                deadline_s = None if hdr is None else float(hdr)
            deadline_s = None if deadline_s is None else float(deadline_s)
            klass = str(body.get("class", "priority"))
            tenant = body.get("tenant")
            tenant = None if tenant is None else str(tenant)
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            self._error(400, "bad_request", f"bad request: {e}",
                        retryable=False)
            return
        rid = body.get("request_id")
        rid = None if rid is None else str(rid)
        if rid is not None:
            state, cached = self._serve.settled.begin(rid,
                                                      wait_timeout=timeout)
            if state == "hit":
                status, payload = cached
                self._reply(status, dict(payload, replayed=True))
                return
            if state == "timeout":
                self._error(504, "client_timeout",
                            f"request_id {rid!r} is still executing its "
                            "first delivery", retryable=True)
                return
        status, payload, headers = self._generate_outcome(
            dict(prompt=prompt, max_new_tokens=max_new, sampling=sampling,
                 eos_id=eos_id, session_id=session_id,
                 keep_session=keep_session, use_prefix=use_prefix,
                 timeout=timeout, klass=klass, deadline_s=deadline_s,
                 tenant=tenant))
        if rid is not None:
            if status == 200 or payload.get("code") == "deadline_exceeded":
                self._serve.settled.settle(rid, status, payload)
            else:
                self._serve.settled.abandon(rid)
        self._reply(status, payload, headers)

    def _generate_outcome(self, kw: dict):
        """One generate call as ``(status, payload, headers)``: the replay
        cache records the outcome before the reply is written."""
        t0 = time.perf_counter()
        try:
            req = self._serve.generate(kw.pop("prompt"), **kw)
        except QueueFullError as e:
            return (429, *error_parts("queue_full", str(e), retryable=True,
                                      retry_after_s=e.retry_after_s))
        except DeadlineExceededError as e:
            r = e.request
            return (504, *error_parts(
                "deadline_exceeded", str(e), retryable=True,
                tokens=list(r.tokens), deadline_s=r.deadline_s,
                phases_ms=r.phase_summary_ms()))
        except TimeoutError as e:
            return (504, *error_parts("client_timeout", str(e),
                                      retryable=True))
        except RuntimeError as e:
            return (500, *error_parts("internal", f"{type(e).__name__}: {e}",
                                      retryable=False))
        except (ValueError, TypeError) as e:
            return (400, *error_parts("bad_request",
                                      f"{type(e).__name__}: {e}",
                                      retryable=False))
        gaps = req.itl_gaps()
        return (200, {
            "tokens": list(req.tokens),
            "session_id": req.session_id,
            "replica": req.replica,
            "class": req.klass,
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "ttft_ms": round((req.t_first_token - req.t_submit) * 1e3, 3)
            if req.t_first_token and req.t_submit else None,
            "max_itl_ms": round(max(gaps) * 1e3, 3) if gaps else None,
            "phases_ms": req.phase_summary_ms(),
        }, None)


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: past the default 5, a burst of clients connecting
    # at once overflows the accept queue and the kernel resets them
    request_queue_size = 128


def make_http_server(serve: ServeServer, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Bind the JSON endpoint (port 0 → ephemeral; see
    ``httpd.server_address``). The caller runs ``serve_forever`` (usually on
    a thread) and pairs it with ``serve.start()``/``serve.stop()``."""
    httpd = _HTTPServer((host, port), _Handler)
    httpd.serve = serve  # type: ignore[attr-defined]
    return httpd
