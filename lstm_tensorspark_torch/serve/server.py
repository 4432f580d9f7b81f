"""Serving front-ends: in-process client and a stdlib HTTP server.

Port of the one-engine path of ``lstm_tensorspark_tpu/serve/server.py``.
:class:`ServeServer` owns one engine, one :class:`Batcher` and the
scheduler thread; :meth:`ServeServer.generate` is the synchronous request
path both front-ends use:

- :class:`InprocessClient` — the same admission, batching and backpressure
  semantics as HTTP, without sockets;
- :func:`make_http_server` — a ``ThreadingHTTPServer`` JSON endpoint:

  - ``POST /v1/generate`` body ``{"prompt": [ids], "max_new_tokens": N,
    "greedy": bool, "temperature": t, "eos_id": id, "timeout": s,
    "session_id": str, "keep_session": bool, "use_prefix": bool}`` →
    ``{"tokens": [...], "session_id": ..., "latency_ms": ..., "ttft_ms":
    ..., "max_itl_ms": ...}``. ``keep_session`` keeps the session's state
    after the request and returns its id; a later request naming that
    ``session_id`` continues it (its prompt is the next fragment);
  - ``GET /healthz`` → scheduler liveness (200 ``ok``, 503 ``down``);
  - ``GET /v1/stats`` (alias ``/stats``) → engine, cache, prefix-cache,
    tier and batcher counters, including the window kernels' launch
    counts and, when speculative, the spec windows and accepted proposals.

  A full queue gets 429; a bad body, a reserved ``session_id`` or an
  unsupported sampling config (top-k, top-p) gets 400; a scheduler-side
  failure (an unknown or busy session) 500 ``internal`` with the
  scheduler's message; a client-side wait past ``timeout`` 504.

:meth:`ServeServer.stop` flushes the engine's tiers, so a clean stop lands
every kept session's checkpoint on the disk tier.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .batcher import Batcher, QueueFullError, Request
from .engine import GREEDY, SamplingParams, ServeEngine

#: a scheduler whose heartbeat is older than this is reported down
STALE_HEARTBEAT_S = 30.0


class ServeServer:
    """One engine (which carries the device), one batcher, one scheduler
    thread. Use as a context manager, or call :meth:`start`/:meth:`stop`."""

    def __init__(self, engine: ServeEngine, *, max_active: int = 16,
                 queue_size: int = 64,
                 window_ladder: tuple[int, ...] = Batcher.DEFAULT_WINDOW_LADDER,
                 prefill_chunk: int | None = None,
                 speculative: bool = False,
                 spec_ladder: tuple[int, ...] = Batcher.DEFAULT_SPEC_LADDER,
                 spec_k: int | None = None):
        self.engine = engine
        self.batcher = Batcher(engine, max_active=max_active,
                               queue_size=queue_size,
                               window_ladder=window_ladder,
                               prefill_chunk=prefill_chunk,
                               speculative=speculative,
                               spec_ladder=spec_ladder, spec_k=spec_k)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def device(self):
        return self.engine.device

    def start(self) -> "ServeServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self.batcher.run,
                                        args=(self._stop,),
                                        name="serve-scheduler", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("scheduler thread did not stop")
            self._thread = None
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
                 timeout: float = 120.0) -> Request:
        """Submit and block until done; returns the filled
        :class:`Request` (``.tokens``, ``.session_id``, timestamps). Raises
        ``ValueError`` (a request the engine will not serve),
        :class:`QueueFullError`, ``TimeoutError`` (the request is then
        cancelled), or ``RuntimeError`` on a scheduler failure (an unknown
        or busy session among them)."""
        req = Request(prompt, max_new_tokens, sampling=sampling, eos_id=eos_id,
                      session_id=session_id, keep_session=keep_session,
                      use_prefix=use_prefix)
        self.batcher.submit(req)
        if not req.done.wait(timeout):
            req.cancelled = True
            raise TimeoutError(f"request {req.id} not completed within "
                               f"{timeout:.0f}s")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req

    def stats(self) -> dict:
        return {"engine": self.engine.stats(), "batcher": self.batcher.stats()}

    def health(self) -> dict:
        alive = self._thread is not None and self._thread.is_alive()
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


class _Handler(BaseHTTPRequestHandler):
    server_version = "lstm-tsp-torch-serve/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # no per-request stderr lines
        pass

    @property
    def _serve(self) -> ServeServer:
        return self.server.serve  # type: ignore[attr-defined]

    def _reply(self, code: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, status: int, code: str, message: str) -> None:
        self._reply(status, {"error": message, "code": code})

    def do_GET(self) -> None:
        if self.path == "/healthz":
            health = self._serve.health()
            self._reply(200 if health["status"] == "ok" else 503, health)
        elif self.path in ("/v1/stats", "/stats"):
            self._reply(200, self._serve.stats())
        else:
            self._error(404, "not_found", f"no route {self.path}")

    def do_POST(self) -> None:
        if self.path != "/v1/generate":
            self._error(404, "not_found", f"no route {self.path}")
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
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            self._error(400, "bad_request", f"bad request: {e}")
            return
        t0 = time.perf_counter()
        try:
            req = self._serve.generate(prompt, max_new_tokens=max_new,
                                       sampling=sampling, eos_id=eos_id,
                                       session_id=session_id,
                                       keep_session=keep_session,
                                       use_prefix=use_prefix,
                                       timeout=timeout)
        except QueueFullError as e:
            self._error(429, "queue_full", str(e))
            return
        except TimeoutError as e:
            self._error(504, "client_timeout", str(e))
            return
        except RuntimeError as e:
            self._error(500, "internal", f"{type(e).__name__}: {e}")
            return
        except (ValueError, TypeError) as e:
            self._error(400, "bad_request", f"{type(e).__name__}: {e}")
            return
        gaps = req.itl_gaps()
        self._reply(200, {
            "tokens": list(req.tokens),
            "session_id": req.session_id,
            "latency_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "ttft_ms": round((req.t_first_token - req.t_submit) * 1e3, 3),
            "max_itl_ms": round(max(gaps) * 1e3, 3) if gaps else None,
        })


def make_http_server(serve: ServeServer, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Bind the JSON endpoint (port 0 → ephemeral; see
    ``httpd.server_address``). The caller runs ``serve_forever`` (usually on
    a thread) and pairs it with ``serve.start()``/``serve.stop()``."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.serve = serve  # type: ignore[attr-defined]
    return httpd
