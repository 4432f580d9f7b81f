"""Continuous-batching scheduler over the serve engine.

Port of the core of ``lstm_tensorspark_tpu/serve/batcher.py``. One
scheduler iteration (:meth:`Batcher.step`) does, in order:

1. **admission** — pop queued requests FIFO (one sampling config per
   admission batch; capped by ``max_active`` and the engine's largest
   batch bucket), acquire and pin a cache slot for each. A request naming
   a ``session_id`` continues that session: from its device slot, or,
   when it was evicted, from the engine's tiers (pending spill, host RAM,
   disk: one ``fill_batch`` for the whole admission); a session nothing
   holds fails as "unknown session". A fresh prompt looks up the **prefix
   cache** (``engine.prefix``): a hit resumes prefill at the matched
   offset, gathering from the entry's slot;
2. **prefill** — without ``prefill_chunk`` every admitted prompt runs now
   (one dispatch, plus one head-less chunk where a prefix-insert split is
   due); with ``prefill_chunk=C`` at most ONE bounded dispatch (<= C
   tokens a row) per iteration, so a long prompt interleaves with decode
   instead of stalling every running session, and prompts of any length
   are served. Each request gets its first token from its final chunk;
3. **decode** — advance every active session. In steady state (empty
   queue, nothing mid-prefill, one sampling group that fits one batch
   bucket) the advance is a **decode window** of K tokens from the ladder
   (default 1/4/8, the largest rung no session would overshoot), and the
   next window is dispatched from the previous one's device handles
   *before* the host reads the previous one's tokens. Rows that emit their
   EOS or exhaust their budget latch dead on the device (frozen carries,
   PAD output), which is what makes running ahead safe. Otherwise every
   group advances one token (K=1) per iteration.

**Prefix discipline**: a lookup ref-holds the matched entry (its slot
pinned) until the resumed prefill is DISPATCHED; stream order covers the
rest. A fresh prompt passing a stride boundary ``k`` snapshots the state
after ``prompt[:k]`` into a new entry (one slot copy); continuations
neither match nor insert (their prompts are fragments, not prefixes).

**Kept sessions**: a completed ``keep_session`` request leaves its
session's carries in its slot, unpinned (LRU-evictable), with a
write-behind checkpoint to the disk tier; any other completion releases
the slot and discards the tiers' copies. Greedy output is the
uninterrupted ``generate`` of the whole context whichever way the state
came back, with the prefix cache cold, hot or off, chunked or not.

**Speculative scheduling** (``speculative=True``, a draft attached to the
engine): every prefill dispatch is mirrored by a draft prefill over the
same fragments, the draft starting from zero at each session's first
fragment (a failed mirror is counted in ``draft_prefill_failures`` and
otherwise ignored: draft state moves only acceptance, never a token). In
steady state a greedy group then advances by **speculative windows**: the
draft proposes K_draft tokens (the largest ``spec_ladder`` rung, at most
``spec_k``, whose W = K_draft + 1 no session would overshoot; 0 below 2
tokens left) and the target verifies them in one pass, emitting 1..W
tokens a row — the plain greedy sequence. A switch between spec and
plain windows happens only at a scheduler tick.

**Admission classes and deadlines**: every request carries a class
(:data:`CLASSES`: ``priority``, the default, or ``best_effort``) and an
optional deadline. The two class queues are served by weighted
round-robin (``class_weights``, default 4:1; FIFO within a class, plain
FIFO when one class waits). A deadline is an absolute ``perf_counter``
time stamped at first submission, so queue wait counts against it, and it
is checked where it still saves work: an expired queued request is reaped
before it takes a slot or a prefill dispatch, an expired prefill stops
between chunks, and decode stops at window boundaries. The request then
settles with the tokens already delivered under its own ``timeout``
outcome (``timed_out``), never as a failure. A timed-out session is not
kept, and its tier copies are discarded: they lack the partial tokens the
client already has. Its slot is freed only once no dispatched window
still writes it: a row that expires after its successor window was
dispatched is parked under a reserved id (no request can name it) until
that window is fetched.

Backpressure: the submit queue is bounded (the sum of the class queues),
and a full queue raises :class:`QueueFullError` at once (HTTP 429) with a
``retry_after_s`` from the live queue-wait p99
(:func:`retry_after_from_p99`, the router's policy too). The active set is
bounded by ``max_active`` (at most the cache's slots). The scheduler is
single-threaded: ``step`` runs on the server's background thread (``run``)
or directly from tests (``drain``); ``submit`` may be called from any
thread.

Telemetry (``engine.metrics``, every family labelled with ``replica``):
queue depth and wait, scheduler iteration time, server-side TTFT and
inter-token gaps (the load generator's timestamp definitions), windows by
K, prefill chunks, readback latency, speculative acceptance, request
outcomes and deadline expiries by stage, and the sheds and Retry-After
hints of this layer's own bound. Instruments are resolved once here; a
record site costs a lock and an add. ``Request.phases`` keeps each
request's queue / prefill / decode / readback intervals, summarised in the
HTTP reply as ``phases_ms`` and, with a tracer installed (``--trace``),
emitted as the request's timeline row (:meth:`Batcher._emit_timeline`).

The serve autotuner's knobs (``serve/autotune.py``) are the setters
:meth:`Batcher.set_window_cap`, :meth:`Batcher.set_prefill_chunk` (among
the warmed ``prefill_chunk_choices``), :meth:`Batcher.set_spec_k` and
:meth:`Batcher.set_max_active`; each refuses a value outside what
:meth:`Batcher.warmup` warmed.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

import numpy as np

from ..utils import tracing
from .engine import GREEDY, PAD_TOKEN, DecodeWindow, SamplingParams, ServeEngine
from .state_cache import PREFIX_SID_NAMESPACE

#: admission classes, in dequeue-priority order: ``priority`` (the
#: default) and ``best_effort`` (shed first, served at the smaller share)
CLASSES = ("priority", "best_effort")

#: session-id namespace a timed-out row's slot is parked under until the
#: window still writing it is fetched (inside the prefix cache's reserved
#: namespace, so no request can name it)
_PARKED_NAMESPACE = f"{PREFIX_SID_NAMESPACE}timed-out/"


def retry_after_from_p99(p99, fullness: float) -> float:
    """The one Retry-After policy of the router's shed and the batcher's
    own bound: the queue-wait p99 scaled by how full the queue is (0.5 +
    fullness: 1.5x at a full queue), clamped to [0.05 s, 30 s], with a
    0.25 s base when there are no samples yet or the estimate is NaN."""
    base = (float(p99) if isinstance(p99, (int, float)) and p99 == p99
            else 0.0)
    if base <= 0:
        base = 0.25
    return float(min(max(base * (0.5 + fullness), 0.05), 30.0))


def register_shed_instruments(reg):
    """Resolve the shed instruments both admission layers record into
    (one registration site, so name, labels and help cannot drift).
    Returns ``(shed_by_class, tenant_shed_by_class, retry_after_hist)``:
    ``tenant_limited="yes"`` children count the router's per-tenant
    token-bucket 429s, ``"no"`` the capacity sheds."""
    fam = reg.counter(
        "serve_shed_total",
        "429 sheds by admission class (best_effort sheds at its "
        "smaller queue bound while priority keeps the headroom); "
        "tenant_limited=yes marks per-tenant token-bucket rejections",
        labelnames=("class", "tenant_limited"))
    shed = {c: fam.labels(**{"class": c, "tenant_limited": "no"})
            for c in CLASSES}
    tenant_shed = {c: fam.labels(**{"class": c, "tenant_limited": "yes"})
                   for c in CLASSES}
    retry_hist = reg.histogram(
        "serve_retry_after_seconds",
        "Retry-After hints attached to 429 sheds, computed from the "
        "live queue-wait p99 (drain estimate, not a fixed constant)")
    return shed, tenant_shed, retry_hist


class QueueFullError(RuntimeError):
    """Admission control: the bounded queue is full, or the shedding
    policy refused this class (HTTP 429). ``retry_after_s`` is the live
    drain estimate from the queue-wait p99: the client's retry hint."""

    def __init__(self, msg: str, retry_after_s: float | None = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(RuntimeError):
    """The request's deadline lapsed server-side. ``request`` carries the
    partial output generated before expiry; the HTTP layer returns it in
    a 504 ``deadline_exceeded`` body."""

    def __init__(self, request: "Request"):
        super().__init__(
            f"request {request.id} deadline exceeded after "
            f"{len(request.tokens)} token(s)")
        self.request = request


class Request:
    """One generation request; the scheduler fills the result fields and
    publishes them by setting ``done``. ``session_id`` continues a kept
    session (``None``: a new one, whose id the scheduler mints and writes
    back here); ``keep_session`` keeps the session's state after this
    request; ``use_prefix=False`` neither reads nor inserts prefix-cache
    entries. ``klass`` is the admission class (:data:`CLASSES`),
    ``deadline_s`` a server-side budget in seconds from first submission,
    ``tenant`` the router's rate-limit identity (``None``: never
    limited)."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens: int, *,
                 sampling: SamplingParams = GREEDY,
                 session_id: str | None = None,
                 keep_session: bool = False,
                 eos_id: int | None = None,
                 use_prefix: bool = True,
                 klass: str = "priority",
                 deadline_s: float | None = None,
                 tenant: str | None = None):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.max_new_tokens = int(max_new_tokens)
        self.sampling = sampling
        if session_id is not None and session_id.startswith(
                PREFIX_SID_NAMESPACE):
            # the prefix cache's backing slots live in this namespace — a
            # client naming one would inherit (and corrupt) shared state
            raise ValueError(
                f"session_id namespace {PREFIX_SID_NAMESPACE!r} is reserved")
        self.session_id = session_id
        self.keep_session = bool(keep_session)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.use_prefix = bool(use_prefix)
        if klass not in CLASSES:
            raise ValueError(
                f"unknown admission class {klass!r} (classes: "
                f"{', '.join(CLASSES)})")
        self.klass = klass
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = deadline_s
        if tenant is not None:
            tenant = str(tenant)
            if not tenant or len(tenant) > 256:
                raise ValueError(
                    "tenant must be a non-empty string of <= 256 chars")
        self.tenant = tenant
        # the absolute perf_counter deadline, stamped at first submission
        # (so the budget covers queue wait); None without deadline_s
        self.deadline: float | None = None
        # settled by its deadline, with the tokens already generated
        self.timed_out = False
        self.id = next(Request._ids)
        self.replica: int | None = None  # stamped by the router
        self.tokens: list[int] = []
        self.error: str | None = None
        self.cancelled = False  # set by a client that stopped waiting
        self.done = threading.Event()
        self.t_submit: float | None = None
        self.t_admit: float | None = None
        self.t_first_token: float | None = None
        self.t_done: float | None = None
        # (name, start, end) perf_counter intervals: queue, prefill /
        # prefill_chunk, decode / decode_window / spec_window, readback
        self.phases: list[tuple[str, float, float]] = []
        self.t_tokens: list[float] = []  # host arrival time of each token

    def expired(self, now: float | None = None) -> bool:
        """True once the submit-stamped deadline has lapsed."""
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) > self.deadline

    def itl_gaps(self) -> list[float]:
        """Gaps between consecutive token arrivals (a window's burst
        contributes 0.0 gaps): the one definition the HTTP reply's
        ``max_itl_ms`` and the load generator share."""
        return [b - a for a, b in zip(self.t_tokens, self.t_tokens[1:])]

    def phase_summary_ms(self) -> dict[str, float]:
        """Host time per phase in ms (``decode_window`` folds into
        ``decode_ms``). Each phase's intervals are merged as a union, not
        summed: pipelined windows overlap in time, so a sum would exceed
        the request's latency. Different phases still overlap each other
        (a window's readback runs inside the next window's decode)."""
        spans: dict[str, list[tuple[float, float]]] = {}
        for name, a, b in self.phases:
            key = "decode" if name == "decode_window" else name
            spans.setdefault(key, []).append((a, b))
        out = {}
        for key, ivs in spans.items():
            ivs.sort()
            total, cur_a, cur_b = 0.0, ivs[0][0], ivs[0][1]
            for a, b in ivs[1:]:
                if a > cur_b:
                    total += cur_b - cur_a
                    cur_a, cur_b = a, b
                else:
                    cur_b = max(cur_b, b)
            total += cur_b - cur_a
            out[f"{key}_ms"] = round(total * 1e3, 3)
        return out


class _Session:
    __slots__ = ("req", "sid", "slot", "remaining", "last_token")

    def __init__(self, req: Request, sid: str, slot: int):
        self.req = req
        self.sid = sid
        self.slot = slot
        self.remaining = req.max_new_tokens
        self.last_token = 0


class _Prefilling:
    """An admitted session whose prompt is not fully consumed yet. ``pos``
    counts consumed prompt tokens; ``entry`` is the ref-held prefix entry
    the FIRST dispatch gathers from (released, and set to None, once that
    dispatch is enqueued); ``was_fresh``: the session started stateless,
    so its prompt is an absolute prefix, eligible for insertion;
    ``draft_started``: the draft consumed the session's first fragment
    (the draft's first dispatch always starts from zero)."""

    __slots__ = ("sess", "pos", "entry", "was_fresh", "draft_started")

    def __init__(self, sess: _Session, pos: int, entry, was_fresh: bool):
        self.sess = sess
        self.pos = pos
        self.entry = entry
        self.was_fresh = was_fresh
        self.draft_started = False

    def src(self) -> tuple[int, bool]:
        """(src_slot, fresh) of the next prefill dispatch."""
        if self.entry is not None:
            return self.entry.slot, False
        return self.sess.slot, self.was_fresh and self.pos == 0


def _unknown_session(sid: str) -> str:
    return (f"unknown session {sid!r} (expired, never created, or its "
            "spilled state was lost; re-send the full prompt)")


class Batcher:
    DEFAULT_WINDOW_LADDER = (1, 4, 8)
    #: default weighted-dequeue shares (priority, best_effort): of every 5
    #: admissions with both classes waiting, 4 are priority
    DEFAULT_CLASS_WEIGHTS = (4, 1)
    #: default speculative K_draft ladder; rung 0 (plain decode) is always
    #: present
    DEFAULT_SPEC_LADDER = (0, 2, 4)

    def __init__(self, engine: ServeEngine, *, max_active: int = 16,
                 queue_size: int = 64,
                 window_ladder: tuple[int, ...] = DEFAULT_WINDOW_LADDER,
                 prefill_chunk: int | None = None,
                 prefill_chunk_choices: tuple[int, ...] | None = None,
                 class_weights: tuple[int, int] = DEFAULT_CLASS_WEIGHTS,
                 speculative: bool = False,
                 spec_ladder: tuple[int, ...] = DEFAULT_SPEC_LADDER,
                 spec_k: int | None = None):
        if max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {max_active}")
        if max_active > engine.cache.num_slots:
            raise ValueError(
                f"max_active {max_active} exceeds the cache's "
                f"{engine.cache.num_slots} slots — active sessions must "
                "always be able to hold a pinned slot")
        if queue_size < 1:
            raise ValueError(f"queue_size must be >= 1, got {queue_size}")
        if not window_ladder or any(k < 1 for k in window_ladder):
            raise ValueError(f"window_ladder needs positive window sizes, "
                             f"got {window_ladder!r}")
        self._validate_chunk(prefill_chunk, engine)
        if prefill_chunk_choices:
            if prefill_chunk is None:
                # the choice set is the autotuner's range for a chunked
                # scheduler; turning chunking on or off at run time would
                # flip submit()'s prompt-length rule under a client
                raise ValueError(
                    "prefill_chunk_choices needs prefill_chunk set (the "
                    "knob moves among chunk sizes, it cannot turn "
                    "chunking on or off)")
            for c in prefill_chunk_choices:
                self._validate_chunk(int(c), engine)
        if (len(class_weights) != len(CLASSES)
                or any(int(w) < 1 for w in class_weights)):
            raise ValueError(
                f"class_weights needs one positive weight per class "
                f"{CLASSES}, got {class_weights!r}")
        if any(int(k) < 0 for k in spec_ladder):
            raise ValueError(f"spec_ladder needs K_draft >= 0, got "
                             f"{spec_ladder!r}")
        if speculative and not engine.has_draft:
            raise ValueError("speculative=True needs a draft model attached "
                             "to the engine (attach_draft)")
        # rung 0 (plain decode) is always selectable
        self.spec_ladder = tuple(sorted({0} | {int(k) for k in spec_ladder}))
        self.speculative = bool(speculative)
        if not self.speculative:
            self.spec_k = 0
        elif spec_k is None:
            self.spec_k = self.spec_ladder[-1]
        elif spec_k not in self.spec_ladder:
            raise ValueError(f"spec_k {spec_k} is not a spec_ladder rung "
                             f"{self.spec_ladder}")
        else:
            self.spec_k = int(spec_k)
        self.engine = engine
        # the stack's one replica: its index labels the metric children
        self.replica = 0
        self.max_active = max_active
        self.queue_size = queue_size
        # rung 1 is always present: the pick falls back to it near a
        # session's budget end
        self.window_ladder = tuple(sorted({1} | set(window_ladder)))
        # the live ceiling on the window pick (the autotuner's K knob),
        # always a ladder rung; the top rung is the uncapped pick
        self.window_cap = self.window_ladder[-1]
        self.prefill_chunk = prefill_chunk
        # the warmed chunk sizes the autotuner may move prefill_chunk among
        self.prefill_chunk_choices = (
            tuple(sorted({int(c) for c in prefill_chunk_choices}
                         | {prefill_chunk}))
            if prefill_chunk_choices else ())
        # one queue per admission class, dequeued by weighted round-robin
        # over the non-empty ones (the _wrr_seq cursor); queue_size bounds
        # their sum
        self.class_weights = tuple(int(w) for w in class_weights)
        self._queues: dict[str, deque[Request]] = {c: deque()
                                                   for c in CLASSES}
        self._wrr_seq: tuple[str, ...] = tuple(
            c for c, w in zip(CLASSES, self.class_weights) for _ in range(w))
        self._wrr_idx = 0
        # True while a queued request may carry a deadline: gates the
        # per-iteration queue reap, so deadline-less traffic never scans
        self._deadlines_queued = False
        # admitted sessions still consuming their prompt (FIFO; the
        # scheduler thread's — the lock covers reads from stats())
        self._prefilling: list[_Prefilling] = []
        self._active: list[_Session] = []
        # the in-flight window and its rows (scheduler thread only)
        self._pending: tuple[DecodeWindow, list[_Session]] | None = None
        # parked ids of timed-out rows whose slots the in-flight window
        # still writes: freed once that window is fetched
        self._parked: list[str] = []
        self._park_counter = itertools.count()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._sid_counter = itertools.count()
        # minted session ids carry a per-process random part: a restarted
        # server on the same session directory must not mint an id whose
        # file an earlier process wrote
        self._sid_prefix = f"s{self.replica}.{os.urandom(3).hex()}"
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.timed_out = 0  # deadline expiries (queue, prefill, decode)
        self.tokens_generated = 0
        self.prefills_dispatched = 0  # final prefill dispatches
        self.prefill_chunks_dispatched = 0  # head-less chunk dispatches
        self.prefix_resumed = 0  # sessions that resumed from a prefix hit
        self.prefix_tokens_saved = 0  # prompt tokens skipped by the cache
        self.prefill_tokens_computed = 0  # prompt tokens actually run
        self.windows_dispatched: dict[int, int] = {}  # K -> dispatches
        self.windows_pipelined = 0  # dispatched ahead of a pending fetch
        # speculative accounting: spec windows per K_draft, accepted
        # proposals (a live row emits accepted + 1 tokens a window) and the
        # live rows verified, so accepted / rows is the mean accepted length
        self.spec_windows_dispatched: dict[int, int] = {}
        self.spec_accepted_tokens = 0
        self.spec_rows_verified = 0
        self.draft_prefills_dispatched = 0
        self.draft_prefill_failures = 0
        self.last_heartbeat: float | None = None
        self._bind_metrics(engine.metrics)

    def _bind_metrics(self, reg) -> None:
        """Resolve every instrument once (the JAX batcher's families,
        each with a ``replica`` label): a record site then costs a lock
        and an add, and never looks a family up by name."""
        rl = str(self.replica)

        def one(kind, name, help_, **kw):
            return getattr(reg, kind)(name, help_, labelnames=("replica",),
                                      **kw).labels(replica=rl)

        self._m_queue_depth = one("gauge", "serve_queue_depth",
                                  "requests waiting in the submit queue")
        self._m_active = one("gauge", "serve_active_sessions",
                             "sessions in active decode")
        self._m_prefilling = one("gauge", "serve_prefilling_sessions",
                                 "admitted sessions mid-prefill")
        self._m_queue_wait = one("histogram", "serve_queue_wait_seconds",
                                 "submit → admission wait")
        self._m_ttft = one("histogram", "serve_ttft_seconds",
                           "submit → first token (server-side)")
        self._m_itl = one(
            "histogram", "serve_itl_seconds",
            "inter-token gaps, host arrival times (0 within a window burst)")
        self._m_iteration = one(
            "histogram", "serve_scheduler_iteration_seconds",
            "duration of scheduler iterations that did work")
        self._m_readback = one(
            "histogram", "serve_readback_seconds",
            "decode-window dispatch → tokens on host (fetch latency)")
        self._m_chunks = one(
            "counter", "serve_prefill_chunks_total",
            "head-less bounded prefill chunk programs dispatched")
        fam = reg.counter("serve_decode_windows_total",
                          "decode windows dispatched by window size K",
                          labelnames=("k", "replica"))
        self._m_window_k = {k: fam.labels(k=str(k), replica=rl)
                            for k in self.window_ladder}
        self._m_spec_accept = one(
            "histogram", "serve_spec_accept_len",
            "draft proposals accepted per speculative verify window, "
            "per live row",
            buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))
        fam = reg.counter(
            "serve_spec_verify_total",
            "speculative verify windows by per-row outcome",
            labelnames=("outcome", "replica"))
        self._m_spec_outcome = {o: fam.labels(outcome=o, replica=rl)
                                for o in ("full", "partial", "reject")}
        fam = reg.counter("serve_requests_total",
                          "requests by final outcome",
                          labelnames=("outcome", "replica"))
        self._m_req = {o: fam.labels(outcome=o, replica=rl)
                       for o in ("completed", "failed", "rejected",
                                 "timeout")}
        fam = reg.counter(
            "serve_deadline_expired_total",
            "request deadlines that lapsed, by the pipeline stage that "
            "reaped them (queue = before any slot/prefill was spent)",
            labelnames=("stage", "replica"))
        self._m_deadline = {st: fam.labels(stage=st, replica=rl)
                            for st in ("queue", "prefill", "decode")}
        # this layer's own bound sheds with the router's accounting and
        # Retry-After policy (the tenant children are the router's)
        self._m_shed, _, self._m_retry_after = register_shed_instruments(reg)

    # ---- client side ---------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a request on its class queue, or raise: ``ValueError``
        for one the engine cannot serve (prompt too long without
        ``prefill_chunk``, a token id outside the vocabulary, unsupported
        sampling), :class:`QueueFullError` (with ``retry_after_s``) when
        the bounded queue is full. The id check keeps a bad id from
        reaching the embedding gather, where on the card it would be a
        device-side assert that leaves the CUDA context, and so the
        server, unusable. The deadline is stamped here, at the first
        submission only."""
        if self.prefill_chunk is None and req.prompt.size > self.engine.max_prompt_len:
            # chunked prefill lifts this cap: a prompt of any length is
            # consumed prefill_chunk tokens a dispatch
            raise ValueError(
                f"prompt length {req.prompt.size} exceeds the "
                f"engine's largest prefill bucket "
                f"{self.engine.max_prompt_len} "
                "(enable prefill_chunk to serve longer prompts)")
        vocab = self.engine.cfg.vocab_size
        lo, hi = int(req.prompt.min()), int(req.prompt.max())
        if lo < 0 or hi >= vocab:
            raise ValueError(f"prompt token id {lo if lo < 0 else hi} is "
                             f"outside the vocabulary [0, {vocab})")
        self.engine.check_sampling(req.sampling)
        with self._lock:
            if self._qlen_locked() >= self.queue_size:
                retry = self._retry_after_locked()
                self.rejected += 1
                self._m_req["rejected"].inc()
                self._m_shed[req.klass].inc()
                self._m_retry_after.observe(retry)
                raise QueueFullError(
                    f"submit queue full ({self.queue_size} pending); "
                    f"retry after {retry:.2f}s", retry_after_s=retry)
            if req.t_submit is None:
                req.t_submit = time.perf_counter()
                self.submitted += 1
                if req.deadline_s is not None:
                    req.deadline = req.t_submit + req.deadline_s
            if req.deadline is not None:
                self._deadlines_queued = True  # arms the _admit reap
            self._queues[req.klass].append(req)
            self._work.notify()

    def note_shed(self) -> None:
        """Count a request the router shed in front of this replica: the
        batcher's ``rejected`` is the replica's 429 count, whichever layer
        refused (the registry keeps the router's under its own labels)."""
        with self._lock:
            self.rejected += 1

    def _qlen_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _retry_after_locked(self) -> float:
        """Retry-After of this layer's full-queue 429: the queue-wait p99
        through :func:`retry_after_from_p99` at fullness 1.0."""
        s = self._m_queue_wait.summary() or {}
        return retry_after_from_p99(s.get("p99"), 1.0)

    def queued(self) -> int:
        """Requests waiting for admission, over both class queues."""
        with self._lock:
            return self._qlen_locked()


    @staticmethod
    def _validate_chunk(chunk: int | None, engine: ServeEngine) -> None:
        if chunk is None:
            return
        if chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 or None, got {chunk}")
        if chunk > engine.max_prompt_len:
            raise ValueError(
                f"prefill_chunk {chunk} exceeds the largest prefill "
                f"bucket {engine.max_prompt_len} — each chunk is one "
                "bucketed program")
        if (engine.prefix is not None
                and chunk % engine.prefix.stride != 0
                and engine.prefix.stride % chunk != 0):
            # _stop_from stride-aligns every stop before the boundary, so
            # an incompatible chunk would be cut short every dispatch
            raise ValueError(
                f"prefill_chunk {chunk} is not a multiple or divisor "
                f"of prefix stride {engine.prefix.stride} — chunks would "
                "be truncated to stride alignment; pick a compatible "
                "chunk or disable the prefix cache")

    def set_window_cap(self, k: int) -> None:
        """Move the decode-window ceiling to ladder rung ``k`` (the
        autotuner's K knob); takes effect at the next pick. Only warmed
        rungs are accepted."""
        if k not in self.window_ladder:
            raise ValueError(
                f"window cap {k} is not a warmed ladder rung "
                f"{self.window_ladder}")
        with self._lock:
            self.window_cap = int(k)

    def set_max_active(self, n: int) -> None:
        """Move the active-set bound, at most the cache's slot count (the
        rule ``__init__`` enforces: admission must always pin a slot)."""
        if n < 1:
            raise ValueError(f"max_active must be >= 1, got {n}")
        if n > self.engine.cache.num_slots:
            raise ValueError(
                f"max_active {n} exceeds the cache's "
                f"{self.engine.cache.num_slots} slots")
        with self._lock:
            self.max_active = int(n)

    def set_prefill_chunk(self, chunk: int) -> None:
        """Move the prefill chunk size to a member of the warmed
        ``prefill_chunk_choices`` (the autotuner's chunk knob):
        :meth:`warmup` warmed the stops of every mix of them."""
        if chunk not in self.prefill_chunk_choices:
            raise ValueError(
                f"prefill_chunk {chunk} is not in the warmed choice set "
                f"{self.prefill_chunk_choices}")
        with self._lock:
            self.prefill_chunk = int(chunk)

    def set_spec_k(self, k: int) -> None:
        """Move the speculative K_draft cap to spec-ladder rung ``k`` (0 =
        plain decode until it moves back up); takes effect at the next
        pick. Only warmed rungs are accepted."""
        if not self.speculative:
            raise ValueError("set_spec_k on a non-speculative scheduler "
                             "(boot with speculative=True and a draft)")
        if k not in self.spec_ladder:
            raise ValueError(f"spec_k {k} is not a warmed spec-ladder rung "
                             f"{self.spec_ladder}")
        with self._lock:
            self.spec_k = int(k)

    # ---- scheduler side ------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration (admission, bounded prefill progress, a
        decode advance for every active session). Returns True when any
        work was done."""
        self.last_heartbeat = time.monotonic()
        t0 = time.perf_counter()
        did = self._admit()
        did = self._prefill_step() or did
        did = self._decode_all() or did
        with self._lock:
            queued, active = self._qlen_locked(), len(self._active)
            prefilling = len(self._prefilling)
        self._m_queue_depth.set(queued)
        self._m_active.set(active)
        self._m_prefilling.set(prefilling)
        if did:  # idle passes are not iterations that did work
            self._m_iteration.observe(time.perf_counter() - t0)
        self.last_heartbeat = time.monotonic()
        return did

    def _admit(self) -> bool:
        admit: list[Request] = []
        dropped: list[Request] = []
        reaped: list[Request] = []
        now = time.perf_counter()
        with self._lock:
            # reap expired requests from the whole queue first: one
            # rebuild pass per class, and only while a deadline is queued
            if self._deadlines_queued:
                still_armed = False
                for q in self._queues.values():
                    keep: list[Request] = []
                    for r in q:
                        if r.expired(now):
                            reaped.append(r)
                        else:
                            keep.append(r)
                            still_armed = (still_armed
                                           or r.deadline is not None)
                    if len(keep) != len(q):
                        q.clear()
                        q.extend(keep)
                self._deadlines_queued = still_armed
            busy = {s.sid for s in self._active}
            busy.update(p.sess.sid for p in self._prefilling)
            capacity = min(
                self.max_active - len(self._active) - len(self._prefilling),
                self.engine.max_batch)
            nwrr = len(self._wrr_seq)
            while len(admit) < capacity:
                # weighted round-robin over the non-empty class queues
                cls = jpos = None
                for i in range(nwrr):
                    j = (self._wrr_idx + i) % nwrr
                    if self._queues[self._wrr_seq[j]]:
                        cls, jpos = self._wrr_seq[j], j
                        break
                if cls is None:
                    break
                head = self._queues[cls][0]
                if head.cancelled:
                    # a drop is not a service: the cursor stays put
                    self._queues[cls].popleft()
                    dropped.append(head)
                    continue
                # one admission batch is one sampling config; FIFO at the
                # picked head keeps admission starvation-free
                if admit and head.sampling.key() != admit[0].sampling.key():
                    break
                self._queues[cls].popleft()
                self._wrr_idx = (jpos + 1) % nwrr
                admit.append(head)
        for r in dropped:
            self._fail(r, "cancelled before admission")
        for r in reaped:
            # a queue-only lifetime: the timeline holds the one span
            if r.t_submit is not None:
                r.phases.append(("queue", r.t_submit, now))
            self._settle_timeout(r, "queue")
        if not admit:
            return bool(dropped or reaped)
        now = time.perf_counter()
        for req in admit:
            req.t_admit = now
            if req.t_submit is not None:
                self._m_queue_wait.observe(now - req.t_submit)
                req.phases.append(("queue", req.t_submit, now))
        cache, tiers = self.engine.cache, self.engine.tiers
        # continuations whose session left its slot are restored in ONE
        # fill_batch after the loop: [req, sid, slot, fresh, needs_fill]
        records: list[list] = []
        for req in admit:
            sid = req.session_id
            if sid is None:
                # minted ids share a namespace with client-chosen ones:
                # skip any the cache holds, or an anonymous request could
                # inherit (and overwrite) a kept session's carries
                sid = f"{self._sid_prefix}-{next(self._sid_counter)}"
                while sid in cache:
                    sid = f"{self._sid_prefix}-{next(self._sid_counter)}"
            if sid in busy:
                # two in-flight requests on one session would share a slot
                # and corrupt each other's carries
                self._fail(req, f"session {sid!r} is busy (another request "
                                "on it is still decoding)")
                continue
            busy.add(sid)
            try:
                slot, fresh = cache.acquire_pinned(sid)
            except RuntimeError as e:  # cache exhausted by pinned slots
                self._fail(req, f"{type(e).__name__}: {e}")
                continue
            # an explicit continuation of a session no longer in a slot:
            # the tiers restore its exact carries into the pinned slot;
            # nothing restorable fails the request (decoding from zero
            # state would return wrong tokens)
            needs_fill = req.session_id is not None and fresh
            if needs_fill and tiers is None:
                cache.release(sid)
                self._fail(req, _unknown_session(sid))
                continue
            records.append([req, sid, slot, fresh, needs_fill])
        filled = {}
        if any(r[4] for r in records):
            try:
                filled = tiers.fill_batch(
                    [(sid, slot) for _, sid, slot, _, nf in records if nf])
            except Exception as e:  # noqa: BLE001 — fail the fills, serve on
                for req, sid, _, _, nf in records:
                    if nf:
                        cache.release(sid)
                        self._fail(req, f"session fill failed: "
                                        f"{type(e).__name__}: {e}")
                records = [r for r in records if not r[4]]
        for req, sid, slot, fresh, needs_fill in records:
            if needs_fill:
                if not filled.get(sid):
                    cache.release(sid)
                    self._fail(req, _unknown_session(sid))
                    continue
                fresh = False
            # prefix lookup: fresh sessions only (a continuation's prompt
            # is a fragment, not an absolute prefix); a hit is ref-held
            # until its resumed prefill is dispatched
            entry, matched = None, 0
            if fresh and req.use_prefix and self.engine.prefix is not None:
                entry, matched = self.engine.prefix.lookup(req.prompt)
            with self._lock:
                self._prefilling.append(
                    _Prefilling(_Session(req, sid, slot), matched, entry,
                                fresh))
        return True

    # ---- prefill scheduling (chunked and prefix-resumed) -----------------

    def _next_stop(self, p: _Prefilling, chunk: int | None) -> int:
        """Prompt position the next dispatch advances ``p`` to (see
        :meth:`_stop_from`). Requests with ``use_prefix=False`` never
        insert, so they never pay the insert split either."""
        return self._stop_from(p.pos, p.sess.req.prompt.size,
                               p.was_fresh and p.sess.req.use_prefix,
                               chunk=chunk)

    def _stop_from(self, pos: int, total: int, fresh: bool,
                   chunk: int | None = None) -> int:
        """The prompt end, capped by the chunk size. With the prefix cache
        on, a fresh prompt's stops before its last insertable boundary are
        stride-aligned — every stop is then an insert point — and without
        chunking the one split lands on that boundary (the state after
        ``prompt[:k]`` must sit in the session's own slot for the
        one-copy insert). Pure arithmetic: :meth:`warmup` replays it."""
        prefix = self.engine.prefix
        stop = total
        if chunk is not None:
            stop = min(stop, pos + chunk)
        if prefix is not None and fresh:
            k = prefix.boundary(total)
            if pos < k:
                stop = min(stop, k)
                if chunk is not None:
                    aligned = (stop // prefix.stride) * prefix.stride
                    if aligned > pos:
                        stop = aligned
        return stop

    def _select_prefill_batch(
            self, chunk: int | None) -> tuple[list[_Prefilling], bool]:
        """FIFO-fair: the head of the prefilling list always progresses;
        compatible rows ride along — the same phase (final or
        intermediate) and, for finals, the same sampling config."""
        head = self._prefilling[0]
        final = self._next_stop(head, chunk) >= head.sess.req.prompt.size
        skey = head.sess.req.sampling.key()
        batch = []
        for p in self._prefilling:
            if len(batch) >= self.engine.max_batch:
                break
            if (self._next_stop(p, chunk) >= p.sess.req.prompt.size) != final:
                continue
            if final and p.sess.req.sampling.key() != skey:
                continue
            batch.append(p)
        return batch, final

    def _prefill_step(self) -> bool:
        """Advance prompt consumption. Unchunked: run every pending
        prefill to completion now. Chunked: dispatch exactly ONE bounded
        batch and return, so decode interleaves between chunks."""
        if not self._prefilling:
            return False
        chunk = self.prefill_chunk
        now = time.perf_counter()
        for p in list(self._prefilling):
            if p.sess.req.cancelled:
                self._abort_prefilling(p, "cancelled during prefill")
            elif p.sess.req.expired(now):
                # a chunked prefill spans iterations: stop spending chunk
                # dispatches on a lapsed deadline
                self._abort_prefilling(p, None, timeout=True)
        while self._prefilling:
            batch, final = self._select_prefill_batch(chunk)
            self._dispatch_prefill(batch, final, chunk)
            if chunk is not None:
                break
        return True

    def _dispatch_prefill(self, batch: list[_Prefilling], final: bool,
                          chunk: int | None) -> None:
        prefix = self.engine.prefix
        items, draft_items = [], []
        computed = 0
        for p in batch:
            stop = self._next_stop(p, chunk)
            # a stride-aligned insert point: the state after prompt[:pos]
            # sits in the session's own slot (insert dedups existing keys)
            if (prefix is not None and p.was_fresh and p.entry is None
                    and p.sess.req.use_prefix
                    and p.pos >= prefix.stride
                    and p.pos % prefix.stride == 0):
                prefix.insert(p.sess.req.prompt[:p.pos], p.sess.slot)
            src_slot, fresh = p.src()
            fragment = p.sess.req.prompt[p.pos:stop]
            items.append((p.sess.slot, src_slot, fresh, fragment))
            computed += stop - p.pos
            if self.speculative:
                # the draft's first fragment always starts from zero: it
                # has no prefix entries or tier copies to resume from
                draft_items.append((p.sess.slot, not p.draft_started,
                                    fragment))
        t0 = time.perf_counter()
        try:
            if final:
                first = self.engine.prefill(items, batch[0].sess.req.sampling)
                self.prefills_dispatched += 1
            else:
                self.engine.prefill_chunk(items)
                self.prefill_chunks_dispatched += 1
                self._m_chunks.inc()
        except Exception as e:  # noqa: BLE001 — the scheduler keeps serving
            for p in batch:
                self._abort_prefilling(
                    p, f"prefill failed: {type(e).__name__}: {e}")
            return
        self.prefill_tokens_computed += computed
        if draft_items:
            try:
                self.engine.draft_prefill(draft_items)
                self.draft_prefills_dispatched += 1
                for p in batch:
                    p.draft_started = True
            except Exception:  # noqa: BLE001 — acceptance-only state
                self.draft_prefill_failures += 1
        now = time.perf_counter()
        phase = "prefill" if final else "prefill_chunk"
        for p in batch:
            # a final prefill syncs on its first token, so its span covers
            # the device work; a chunk's is the dispatch alone
            p.sess.req.phases.append((phase, t0, now))
        for i, p in enumerate(batch):
            if p.entry is not None:
                # the gather from the prefix slot is enqueued: the ref can
                # drop, and only now did the resume happen
                self.prefix_resumed += 1
                self.prefix_tokens_saved += p.pos
                prefix.release(p.entry)
                p.entry = None
            if not final:
                p.pos = self._next_stop(p, chunk)
                continue
            with self._lock:
                self._prefilling.remove(p)
            s = p.sess
            s.req.t_first_token = now
            if s.req.t_submit is not None:
                self._m_ttft.observe(now - s.req.t_submit)
            self._append_token(s, int(first[i]), now)
            if s.remaining == 0:
                self._finish(s)
            else:
                with self._lock:
                    self._active.append(s)

    def _abort_prefilling(self, p: _Prefilling, error: str | None, *,
                          timeout: bool = False) -> None:
        with self._lock:
            try:
                self._prefilling.remove(p)
            except ValueError:
                return  # already settled
        if p.entry is not None:
            self.engine.prefix.release(p.entry)
            p.entry = None
        self.engine.cache.release(p.sess.sid)
        if timeout:
            self._settle_timeout(p.sess.req, "prefill")
        else:
            self._fail(p.sess.req, error)

    def _decode_all(self) -> bool:
        did = False
        if self._pending is not None:
            self._resolve_pending()
            did = True
            if self._pending is not None:
                return True  # the next window is already in flight
        with self._lock:
            active = list(self._active)
            # a session mid-prefill pins K=1 like a queued request: decode
            # yields to the next prefill chunk every iteration
            queue_empty = not self._qlen_locked() and not self._prefilling
        if not active:
            return did
        now = time.perf_counter()
        for s in active:
            if s.req.cancelled:  # abandoned mid-decode: free the slot now
                self._retire(s)
                self.engine.cache.release(s.sid)
                self._fail(s.req, "cancelled mid-decode")
            elif s.req.expired(now):
                # a decode boundary: settle with the tokens delivered (the
                # session is not kept: see _release_timed_out_session)
                self._retire(s)
                self._release_timed_out_session(s)
                self._settle_timeout(s.req, "decode")
        active = [s for s in active if not s.req.done.is_set()]
        if not active:
            return True
        groups: dict[tuple, list[_Session]] = {}
        for s in active:
            groups.setdefault(s.req.sampling.key(), []).append(s)
        if (queue_empty and len(groups) == 1
                and len(active) <= self.engine.max_batch):
            min_rem = min(s.remaining for s in active)
            kd = self._spec_k_for(active, min_rem)
            if kd > 0:
                self._dispatch_spec_window(active, kd)
                return True
            k = self._pick_window(min_rem)
            if k > 1:
                self._dispatch_window(active, k)
                return True
        for group in groups.values():
            for i in range(0, len(group), self.engine.max_batch):
                chunk = group[i:i + self.engine.max_batch]
                t0 = time.perf_counter()
                try:
                    nxt = self.engine.decode([s.slot for s in chunk],
                                             [s.last_token for s in chunk],
                                             chunk[0].req.sampling)
                except Exception as e:  # noqa: BLE001 — keep serving
                    self._fail_chunk(chunk, f"decode failed: "
                                            f"{type(e).__name__}: {e}")
                    continue
                now = time.perf_counter()
                for s, tok in zip(chunk, nxt):
                    s.req.phases.append(("decode", t0, now))
                    self._append_token(s, int(tok), now)
                    if s.remaining == 0:
                        self._retire(s)
                        self._finish(s)
        return True

    def _pick_window(self, min_remaining: int) -> int:
        """Largest ladder rung no session would overshoot, at most
        ``window_cap``."""
        k = 1
        cap = self.window_cap
        for w in self.window_ladder:
            if w <= min_remaining and w <= cap:
                k = max(k, w)
        return k

    def _spec_k_for(self, sessions: list[_Session], min_remaining: int) -> int:
        """K_draft for a speculative window over ``sessions``, or 0 for
        plain decode: speculation serves greedy groups only, needs at least
        2 tokens left, and takes the largest rung under ``spec_k`` whose
        window W = K_draft + 1 no session would overshoot."""
        if not self.speculative or self.spec_k <= 0 or min_remaining < 2:
            return 0
        if not sessions[0].req.sampling.greedy:
            return 0
        k = 0
        for r in self.spec_ladder:
            if 0 < r <= self.spec_k and r + 1 <= min_remaining:
                k = max(k, r)
        return k

    def _dispatch_spec_window(self, sessions: list[_Session], kd: int) -> None:
        try:
            win = self.engine.spec_window(
                [s.slot for s in sessions], [s.last_token for s in sessions],
                [s.remaining for s in sessions],
                [-1 if s.req.eos_id is None else s.req.eos_id
                 for s in sessions], k_draft=kd)
        except Exception as e:  # noqa: BLE001 — keep serving
            self._fail_chunk(sessions, f"decode failed: {type(e).__name__}: {e}")
            return
        self.spec_windows_dispatched[kd] = (
            self.spec_windows_dispatched.get(kd, 0) + 1)
        self._pending = (win, list(sessions))

    def _dispatch_window(self, sessions: list[_Session], k: int) -> None:
        try:
            win = self.engine.decode_window(
                [s.slot for s in sessions], [s.last_token for s in sessions],
                [s.remaining for s in sessions],
                [-1 if s.req.eos_id is None else s.req.eos_id
                 for s in sessions],
                sessions[0].req.sampling, window=k)
        except Exception as e:  # noqa: BLE001 — keep serving
            self._fail_chunk(sessions, f"decode failed: {type(e).__name__}: {e}")
            return
        self._count_window(k)
        self._pending = (win, list(sessions))

    def _count_window(self, k: int) -> None:
        self.windows_dispatched[k] = self.windows_dispatched.get(k, 0) + 1
        m = self._m_window_k.get(k)
        if m is not None:  # ladder rungs are resolved up front
            m.inc()

    def _resolve_pending(self, pipeline: bool = True) -> None:
        """Dispatch the in-flight window's successor from its device handles
        (while steady state holds), then fetch and distribute its tokens.
        The slots parked while this window was in flight are freed once it
        has been fetched (or its successor failed)."""
        win, sessions = self._pending
        self._pending = None
        parked, self._parked = self._parked, []
        try:
            self._resolve(win, sessions, pipeline)
        finally:
            for sid in parked:
                self.engine.cache.release(sid)

    def _resolve(self, win: DecodeWindow, sessions: list[_Session],
                 pipeline: bool) -> None:
        with self._lock:
            queue_empty = not self._qlen_locked() and not self._prefilling
            same_rows = self._active == sessions
        now0 = time.perf_counter()
        # an expired (or cancelled, or settled) row stops the pipeline:
        # its window boundary is where the deadline is honoured
        stop = any(s.req.cancelled or s.req.done.is_set()
                   or s.req.expired(now0) for s in sessions)
        if pipeline and queue_empty and same_rows and not stop:
            # budgets after the unfetched window, assuming full consumption
            # (rows that hit EOS early are latched frozen on the device)
            live = [r for r in (s.remaining - win.window for s in sessions)
                    if r > 0]
            if live and win.spec:
                # a spec successor only while speculation still picks a
                # rung; otherwise the next tick dispatches plain (spec <->
                # plain switches happen at a tick, never in the pipeline)
                kd = self._spec_k_for(sessions, min(live))
                if kd > 0:
                    try:
                        nxt = self.engine.spec_window_next(win, k_draft=kd)
                    except Exception as e:  # noqa: BLE001 — keep serving
                        self._fail_chunk(sessions, f"decode failed: "
                                                   f"{type(e).__name__}: {e}")
                        return
                    self.spec_windows_dispatched[kd] = (
                        self.spec_windows_dispatched.get(kd, 0) + 1)
                    self.windows_pipelined += 1
                    self._pending = (nxt, list(sessions))
            elif live:
                try:
                    nxt = self.engine.decode_window_next(
                        win, window=self._pick_window(min(live)))
                except Exception as e:  # noqa: BLE001 — keep serving
                    self._fail_chunk(sessions, f"decode failed: "
                                               f"{type(e).__name__}: {e}")
                    return
                self._count_window(nxt.window)
                self.windows_pipelined += 1
                self._pending = (nxt, list(sessions))
        t_fetch = time.perf_counter()
        toks, dev_rem, dev_alive = self.engine.fetch_window_summary(win)
        now = time.perf_counter()
        self._m_readback.observe(now - win.t_dispatch)
        for i, (s, row) in enumerate(zip(sessions, toks)):
            if s.req.cancelled or s.req.done.is_set():
                continue
            s.req.phases.append(("spec_window" if win.spec
                                 else "decode_window", win.t_dispatch,
                                 t_fetch))
            s.req.phases.append(("readback", t_fetch, now))
            if win.spec:
                # a live row emits accepted + 1 tokens (the correction
                # rides along); 0 emitted means dead at entry, not a reject
                emitted = 0
                for tok in row:
                    if tok == PAD_TOKEN:
                        break
                    emitted += 1
                if emitted > 0:
                    accepted = emitted - 1
                    self.spec_accepted_tokens += accepted
                    self.spec_rows_verified += 1
                    self._m_spec_accept.observe(float(accepted))
                    self._m_spec_outcome[
                        "full" if accepted >= win.window - 1
                        else "partial" if accepted > 0 else "reject"].inc()
            for tok in row:
                if tok == PAD_TOKEN or s.remaining == 0:
                    break
                self._append_token(s, int(tok), now)
            if not dev_alive[i] or dev_rem[i] <= 0:
                s.remaining = 0  # the device latch is the liveness authority
            if s.remaining == 0:
                self._retire(s)
                self._finish(s)
            elif s.req.expired(now):
                # a window boundary is a deadline boundary: this window's
                # tokens were delivered above, the request settles now
                self._retire(s)
                self._release_timed_out_session(s)
                self._settle_timeout(s.req, "decode")

    def _fail_chunk(self, sessions: list[_Session], error: str) -> None:
        for s in sessions:
            self._retire(s)
            self.engine.cache.release(s.sid)
            self._fail(s.req, error)

    def _append_token(self, s: _Session, tok: int, t: float) -> None:
        if s.req.t_tokens:
            # the gap definition Request.itl_gaps and the load generator use
            self._m_itl.observe(t - s.req.t_tokens[-1])
        s.req.tokens.append(tok)
        s.req.t_tokens.append(t)
        s.last_token = tok
        s.remaining -= 1
        self.tokens_generated += 1
        if s.req.eos_id is not None and tok == s.req.eos_id:
            s.remaining = 0

    def _release_timed_out_session(self, s: _Session) -> None:
        """Free a timed-out session's slot and discard its tier copies.
        The client got partial tokens this turn, so a copy from the last
        completed boundary would resurrect the conversation without them:
        a later continuation fails "unknown session" instead. (Failures
        keep the copies: a failed request delivered nothing.) When the
        in-flight window still carries the row, the slot is parked under
        a reserved id until that window is fetched: the session id is
        gone at once, the slot is not handed out before the window that
        writes it has been resolved."""
        tiers = self.engine.tiers
        if tiers is not None:
            tiers.discard(s.sid)
        pend = self._pending
        if pend is not None and any(r is s for r in pend[1]):
            parked = f"{_PARKED_NAMESPACE}{next(self._park_counter)}"
            if self.engine.cache.rename(s.sid, parked):
                self._parked.append(parked)
                return
        self.engine.cache.release(s.sid)

    def _retire(self, s: _Session) -> None:
        """Leave the active set (the slot is the caller's to keep or
        release)."""
        with self._lock:
            if s in self._active:
                self._active.remove(s)

    def _finish(self, s: _Session) -> None:
        tiers = self.engine.tiers
        if s.req.keep_session:
            # the carries stay in the slot, unpinned (LRU-evictable), so a
            # request naming this session continues in place; the tiers
            # write its request-boundary state behind to the disk tier
            self.engine.cache.unpin(s.sid)
            s.req.session_id = s.sid
            if tiers is not None:
                tiers.checkpoint(s.sid)
        else:
            self.engine.cache.release(s.sid)
            if tiers is not None:
                # the conversation ended un-kept: an older tier copy must
                # not resurrect it. (Failures keep the copies: the last
                # completed boundary is a failed request's recovery point.)
                tiers.discard(s.sid)
        s.req.t_done = time.perf_counter()
        self.completed += 1
        self._m_req["completed"].inc()
        self._emit_timeline(s.req)
        s.req.done.set()

    def _fail(self, req: Request, error: str) -> None:
        req.error = error
        req.t_done = time.perf_counter()
        self.failed += 1
        self._m_req["failed"].inc()
        self._emit_timeline(req)
        req.done.set()

    def _settle_timeout(self, req: Request, stage: str) -> None:
        """Settle a deadline-expired request: its own ``timeout`` outcome
        (never "failed": the client gets every token that was ready),
        counted by the stage that reaped it."""
        req.timed_out = True
        req.t_done = time.perf_counter()
        self.timed_out += 1
        self._m_req["timeout"].inc()
        self._m_deadline[stage].inc()
        self._emit_timeline(req)
        req.done.set()

    @staticmethod
    def _emit_timeline(req: Request) -> None:
        """Emit the request's phases into the installed tracer
        (``--trace``): one complete event a phase on a row of the request's
        own, plus a ``failed`` span for a failure. No tracer: nothing."""
        t = tracing.get_tracer()
        if t is None or not req.phases:
            return
        tid = req.id
        t.set_tid_name(tid, f"request {req.id}")
        for name, a, b in req.phases:
            t.complete(name, a, b, tid=tid, request=req.id)
        if req.error is not None:
            t.complete("failed", req.phases[-1][2], req.t_done, tid=tid,
                       request=req.id, error=req.error)

    # ---- run loops ---------------------------------------------------------

    def warmup(self, sampling: SamplingParams = GREEDY,
               prompt_lens: tuple[int, ...] = (1,)) -> int:
        """Warm everything this scheduler can dispatch for these prompt
        lengths. The chunk and prefix-insert split lengths are scheduler
        policy, so this replays :meth:`_stop_from`'s stops for each length
        — a cold fresh prompt, a fresh prompt resumed from any prefix hit,
        a continuation fragment — with every chunk size the scheduler can
        run (the live one and each of ``prefill_chunk_choices``, in any
        mix: a knob move can land mid-prompt), and warms the union of
        final and intermediate lengths, every window-ladder rung and, when
        speculative, the draft prefills and every spec-ladder rung, for
        every batch bucket."""
        finals: set[int] = set()
        chunks: set[int] = set()
        prefix = self.engine.prefix
        with self._lock:
            live_chunk = self.prefill_chunk
        chunk_values = sorted({live_chunk} | set(self.prefill_chunk_choices),
                              key=lambda c: (c is None, c))
        for t in prompt_lens:
            t = max(1, int(t))
            stack = [(0, True), (0, False)]
            if prefix is not None:
                for k in range(prefix.stride, prefix.boundary(t) + 1,
                               prefix.stride):
                    stack.append((k, True))
            seen: set[tuple[int, bool]] = set()
            while stack:
                pos, fresh = stack.pop()
                if pos >= t or (pos, fresh) in seen:
                    continue
                seen.add((pos, fresh))
                for chunk in chunk_values:
                    stop = self._stop_from(pos, t, fresh, chunk=chunk)
                    (finals if stop >= t else chunks).add(stop - pos)
                    if stop < t:
                        stack.append((stop, fresh))
        return self.engine.warmup(
            sampling, prompt_lens=tuple(sorted(finals)),
            windows=self.window_ladder,
            spec_windows=self.spec_ladder if self.speculative else (),
            chunk_lens=tuple(sorted(chunks)))

    def drain(self) -> None:
        """Drive the scheduler until no work remains (tests, offline)."""
        while self.step():
            pass

    def run(self, stop_event: threading.Event, idle_wait: float = 0.05) -> None:
        """Scheduler loop for the server's background thread."""
        while not stop_event.is_set():
            if self.step():
                continue
            with self._work:
                if (not self._qlen_locked() and not self._active
                        and not self._prefilling):
                    self._work.wait(timeout=idle_wait)
            self.last_heartbeat = time.monotonic()
        if self._pending is not None:
            # deliver the in-flight window's tokens; dispatch nothing more
            self._resolve_pending(pipeline=False)
        for p in list(self._prefilling):
            self._abort_prefilling(p, "server stopped during prefill")
        with self._lock:
            leftovers = list(self._active)
            for q in self._queues.values():
                leftovers.extend(q)
                q.clear()
        for item in leftovers:
            if isinstance(item, _Session):
                self._retire(item)
                self.engine.cache.release(item.sid)
                item = item.req
            if not item.done.is_set():
                self._fail(item, "server stopped")

    def fail_all(self, reason: str) -> int:
        """Fail every queued and admitted request with ``reason`` and free
        their slots and prefix refs: the router's retirement of a replica
        whose scheduler thread died (only then, so nothing else touches
        this state). An admitted row's decode position is indeterminate
        under dispatch-ahead windows, so it is failed, not resumed.
        Returns the number failed."""
        with self._lock:
            queued = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
            prefilling = list(self._prefilling)
            self._prefilling.clear()
            active = list(self._active)
            self._active.clear()
        self._pending = None
        for p in prefilling:
            if p.entry is not None:
                self.engine.prefix.release(p.entry)
                p.entry = None
            self.engine.cache.release(p.sess.sid)
        for s in active:
            self.engine.cache.release(s.sid)
        for sid in self._parked:
            self.engine.cache.release(sid)
        self._parked = []
        reqs = queued + [p.sess.req for p in prefilling] + [
            s.req for s in active]
        for req in reqs:
            if not req.done.is_set():
                self._fail(req, reason)
        return len(reqs)

    def stats(self) -> dict:
        with self._lock:
            queued, active = self._qlen_locked(), len(self._active)
            queued_by_class = {c: len(q) for c, q in self._queues.items()}
            prefilling = len(self._prefilling)
            submitted, rejected = self.submitted, self.rejected
            window_cap, prefill_chunk = self.window_cap, self.prefill_chunk
            max_active, spec_k = self.max_active, self.spec_k
        return {
            "replica": self.replica,
            "submitted": submitted,
            "completed": self.completed,
            "rejected": rejected,
            "failed": self.failed,
            "timed_out": self.timed_out,
            "queued_by_class": queued_by_class,
            "class_weights": list(self.class_weights),
            "queued": queued,
            "active": active,
            "prefilling": prefilling,
            "max_active": max_active,
            "queue_size": self.queue_size,
            "tokens_generated": self.tokens_generated,
            "prefills_dispatched": self.prefills_dispatched,
            "prefill_chunk": prefill_chunk,
            "prefill_chunk_choices": list(self.prefill_chunk_choices),
            "prefill_chunks_dispatched": self.prefill_chunks_dispatched,
            "prefix_resumed": self.prefix_resumed,
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "window_ladder": list(self.window_ladder),
            "window_cap": window_cap,
            "windows_dispatched": dict(self.windows_dispatched),
            "windows_pipelined": self.windows_pipelined,
            "speculative": self.speculative,
            "spec_ladder": list(self.spec_ladder),
            "spec_k": spec_k,
            "spec_windows_dispatched": dict(self.spec_windows_dispatched),
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_rows_verified": self.spec_rows_verified,
            "draft_prefills_dispatched": self.draft_prefills_dispatched,
            "draft_prefill_failures": self.draft_prefill_failures,
        }
