"""Continuous-batching scheduler over the serve engine.

Port of the core of ``lstm_tensorspark_tpu/serve/batcher.py``. One
scheduler iteration (:meth:`Batcher.step`) does, in order:

1. **admission** — pop queued requests FIFO (one sampling config per
   prefill batch; capped by ``max_active`` and the engine's largest batch
   bucket), acquire and pin a cache slot for each;
2. **prefill** — one bucketed batched prefill per sampling group of the
   admitted requests; each request gets its first token here;
3. **decode** — advance every active session. In steady state (empty
   queue, one sampling group that fits one batch bucket) the advance is a
   **decode window** of K tokens from the ladder (default 1/4/8, the
   largest rung no session would overshoot), and the next window is
   dispatched from the previous one's device handles *before* the host
   reads the previous one's tokens. Rows that emit their EOS or exhaust
   their budget latch dead on the device (frozen carries, PAD output),
   which is what makes running ahead safe. Otherwise every group advances
   one token (K=1) per iteration, so a queued request is admitted at the
   next iteration.

**Speculative scheduling** (``speculative=True``, a draft attached to the
engine): every prefill is mirrored by a draft prefill, so the draft's
state tracks each session's prompt (a failed mirror is counted in
``draft_prefill_failures`` and otherwise ignored: draft state moves only
acceptance, never a token). In steady state a greedy group then advances
by **speculative windows** instead of decode windows: the draft proposes
K_draft tokens (the largest ``spec_ladder`` rung, at most ``spec_k``,
whose W = K_draft + 1 no session would overshoot; 0 below 2 tokens left)
and the target verifies them in one pass, emitting 1..W tokens per row —
the plain greedy sequence. Spec windows chain from device handles like
decode windows while a rung is picked; a switch between spec and plain
windows happens only at a scheduler tick.

Backpressure: the submit queue is bounded, and a full queue raises
:class:`QueueFullError` at once (HTTP 429). The active set is bounded by
``max_active`` (at most the cache's slots). The scheduler is
single-threaded: ``step`` runs on the server's background thread (``run``)
or directly from tests (``drain``); ``submit`` may be called from any
thread.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np

from .engine import GREEDY, PAD_TOKEN, DecodeWindow, SamplingParams, ServeEngine


class QueueFullError(RuntimeError):
    """Admission control: the bounded submit queue is full (HTTP 429)."""


class Request:
    """One generation request; the scheduler fills the result fields and
    publishes them by setting ``done``."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens: int, *,
                 sampling: SamplingParams = GREEDY,
                 eos_id: int | None = None):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.max_new_tokens = int(max_new_tokens)
        self.sampling = sampling
        self.eos_id = None if eos_id is None else int(eos_id)
        self.id = next(Request._ids)
        self.tokens: list[int] = []
        self.error: str | None = None
        self.cancelled = False  # set by a client that stopped waiting
        self.done = threading.Event()
        self.t_submit: float | None = None
        self.t_first_token: float | None = None
        self.t_done: float | None = None
        self.t_tokens: list[float] = []  # host arrival time of each token

    def itl_gaps(self) -> list[float]:
        """Gaps between consecutive token arrivals (a window's burst
        contributes 0.0 gaps)."""
        return [b - a for a, b in zip(self.t_tokens, self.t_tokens[1:])]


class _Session:
    __slots__ = ("req", "sid", "slot", "remaining", "last_token")

    def __init__(self, req: Request, sid: str, slot: int):
        self.req = req
        self.sid = sid
        self.slot = slot
        self.remaining = req.max_new_tokens
        self.last_token = 0


class Batcher:
    DEFAULT_WINDOW_LADDER = (1, 4, 8)
    #: default speculative K_draft ladder; rung 0 (plain decode) is always
    #: present
    DEFAULT_SPEC_LADDER = (0, 2, 4)

    def __init__(self, engine: ServeEngine, *, max_active: int = 16,
                 queue_size: int = 64,
                 window_ladder: tuple[int, ...] = DEFAULT_WINDOW_LADDER,
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
        self.max_active = max_active
        self.queue_size = queue_size
        # rung 1 is always present: the pick falls back to it near a
        # session's budget end
        self.window_ladder = tuple(sorted({1} | set(window_ladder)))
        self._queue: deque[Request] = deque()
        self._active: list[_Session] = []
        # the in-flight window and its rows (scheduler thread only)
        self._pending: tuple[DecodeWindow, list[_Session]] | None = None
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._sid_counter = itertools.count()
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.tokens_generated = 0
        self.prefills_dispatched = 0
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

    # ---- client side ---------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a request, or raise: ``ValueError`` for one the engine
        cannot serve (prompt too long, a token id outside the vocabulary,
        unsupported sampling), :class:`QueueFullError` when the bounded
        queue is full. The id check keeps a bad id from reaching the
        embedding gather, where on the card it would be a device-side
        assert that leaves the CUDA context, and so the server, unusable."""
        if req.prompt.size > self.engine.max_prompt_len:
            raise ValueError(
                f"prompt length {req.prompt.size} exceeds the engine's "
                f"largest prefill bucket {self.engine.max_prompt_len}")
        vocab = self.engine.cfg.vocab_size
        lo, hi = int(req.prompt.min()), int(req.prompt.max())
        if lo < 0 or hi >= vocab:
            raise ValueError(f"prompt token id {lo if lo < 0 else hi} is "
                             f"outside the vocabulary [0, {vocab})")
        self.engine.check_sampling(req.sampling)
        with self._lock:
            if len(self._queue) >= self.queue_size:
                self.rejected += 1
                raise QueueFullError(
                    f"submit queue full ({self.queue_size} pending)")
            req.t_submit = time.perf_counter()
            self.submitted += 1
            self._queue.append(req)
            self._work.notify()

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
        """One scheduler iteration (admission + prefill + a decode advance
        for every active session). Returns True when any work was done."""
        self.last_heartbeat = time.monotonic()
        did = self._admit()
        did = self._decode_all() or did
        self.last_heartbeat = time.monotonic()
        return did

    def _admit(self) -> bool:
        admit: list[Request] = []
        dropped: list[Request] = []
        with self._lock:
            capacity = min(self.max_active - len(self._active),
                           self.engine.max_batch)
            while self._queue and len(admit) < capacity:
                head = self._queue[0]
                if head.cancelled:
                    self._queue.popleft()
                    dropped.append(head)
                    continue
                admit.append(self._queue.popleft())
        for r in dropped:
            self._fail(r, "cancelled before admission")
        if not admit:
            return bool(dropped)
        # one prefill batch per sampling config, in admission order
        groups: dict[tuple, list[_Session]] = {}
        for req in admit:
            sid = f"s{next(self._sid_counter)}"
            try:
                slot, _ = self.engine.cache.acquire_pinned(sid)
            except RuntimeError as e:  # cache exhausted by pinned slots
                self._fail(req, f"{type(e).__name__}: {e}")
                continue
            groups.setdefault(req.sampling.key(), []).append(
                _Session(req, sid, slot))
        for sessions in groups.values():
            self._prefill(sessions)
        return True

    def _prefill(self, sessions: list[_Session]) -> None:
        items = [(s.slot, True, s.req.prompt) for s in sessions]
        try:
            first = self.engine.prefill(items, sessions[0].req.sampling)
        except Exception as e:  # noqa: BLE001 — the scheduler keeps serving
            for s in sessions:
                self.engine.cache.release(s.sid)
                self._fail(s.req, f"prefill failed: {type(e).__name__}: {e}")
            return
        self.prefills_dispatched += 1
        if self.speculative:
            # the draft consumes the same prompts, from zero: the port has
            # no chunked prefill, so this is always a session's first
            # (and only) prompt fragment
            try:
                self.engine.draft_prefill(items)
                self.draft_prefills_dispatched += 1
            except Exception:  # noqa: BLE001 — acceptance-only state
                self.draft_prefill_failures += 1
        now = time.perf_counter()
        for s, tok in zip(sessions, first):
            s.req.t_first_token = now
            self._append_token(s, int(tok), now)
            if s.remaining == 0:
                self._finish(s)
            else:
                with self._lock:
                    self._active.append(s)

    def _decode_all(self) -> bool:
        did = False
        if self._pending is not None:
            self._resolve_pending()
            did = True
            if self._pending is not None:
                return True  # the next window is already in flight
        with self._lock:
            active = list(self._active)
            queue_empty = not self._queue
        for s in active:
            if s.req.cancelled:  # abandoned mid-decode: free the slot now
                self._retire(s)
                self._fail(s.req, "cancelled mid-decode")
        active = [s for s in active if not s.req.done.is_set()]
        if not active:
            return did
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
                    self._append_token(s, int(tok), now)
                    if s.remaining == 0:
                        self._retire(s)
                        self._finish(s)
        return True

    def _pick_window(self, min_remaining: int) -> int:
        """Largest ladder rung no session would overshoot."""
        k = 1
        for w in self.window_ladder:
            if w <= min_remaining:
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
        self.windows_dispatched[k] = self.windows_dispatched.get(k, 0) + 1
        self._pending = (win, list(sessions))

    def _resolve_pending(self, pipeline: bool = True) -> None:
        """Dispatch the in-flight window's successor from its device handles
        (while steady state holds), then fetch and distribute its tokens."""
        win, sessions = self._pending
        self._pending = None
        with self._lock:
            queue_empty = not self._queue
            same_rows = self._active == sessions
        stop = any(s.req.cancelled or s.req.done.is_set() for s in sessions)
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
                self.windows_dispatched[nxt.window] = (
                    self.windows_dispatched.get(nxt.window, 0) + 1)
                self.windows_pipelined += 1
                self._pending = (nxt, list(sessions))
        toks, dev_rem, dev_alive = self.engine.fetch_window_summary(win)
        now = time.perf_counter()
        for i, (s, row) in enumerate(zip(sessions, toks)):
            if s.req.cancelled or s.req.done.is_set():
                continue
            if win.spec:
                # a live row emits accepted + 1 tokens (the correction
                # rides along); 0 emitted means dead at entry, not a reject
                emitted = 0
                for tok in row:
                    if tok == PAD_TOKEN:
                        break
                    emitted += 1
                if emitted > 0:
                    self.spec_accepted_tokens += emitted - 1
                    self.spec_rows_verified += 1
            for tok in row:
                if tok == PAD_TOKEN or s.remaining == 0:
                    break
                self._append_token(s, int(tok), now)
            if not dev_alive[i] or dev_rem[i] <= 0:
                s.remaining = 0  # the device latch is the liveness authority
            if s.remaining == 0:
                self._retire(s)
                self._finish(s)

    def _fail_chunk(self, sessions: list[_Session], error: str) -> None:
        for s in sessions:
            self._retire(s)
            self._fail(s.req, error)

    def _append_token(self, s: _Session, tok: int, t: float) -> None:
        s.req.tokens.append(tok)
        s.req.t_tokens.append(t)
        s.last_token = tok
        s.remaining -= 1
        self.tokens_generated += 1
        if s.req.eos_id is not None and tok == s.req.eos_id:
            s.remaining = 0

    def _retire(self, s: _Session) -> None:
        """Leave the active set and free the slot."""
        with self._lock:
            if s in self._active:
                self._active.remove(s)
        self.engine.cache.release(s.sid)

    def _finish(self, s: _Session) -> None:
        self.engine.cache.release(s.sid)
        s.req.t_done = time.perf_counter()
        self.completed += 1
        s.req.done.set()

    def _fail(self, req: Request, error: str) -> None:
        req.error = error
        req.t_done = time.perf_counter()
        self.failed += 1
        req.done.set()

    # ---- run loops ---------------------------------------------------------

    def warmup(self, sampling: SamplingParams = GREEDY,
               prompt_lens: tuple[int, ...] = (1,)) -> int:
        """Warm every program this scheduler can dispatch: the engine's
        prefill buckets covering ``prompt_lens`` and every window-ladder
        rung, for every batch bucket; when speculative, the draft prefills
        and every spec-ladder rung too."""
        return self.engine.warmup(
            sampling, prompt_lens=prompt_lens, windows=self.window_ladder,
            spec_windows=self.spec_ladder if self.speculative else ())

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
                if not self._queue and not self._active:
                    self._work.wait(timeout=idle_wait)
            self.last_heartbeat = time.monotonic()
        if self._pending is not None:
            # deliver the in-flight window's tokens; dispatch nothing more
            self._resolve_pending(pipeline=False)
        with self._lock:
            leftovers = list(self._active) + list(self._queue)
            self._queue.clear()
        for item in leftovers:
            if isinstance(item, _Session):
                self._retire(item)
                item = item.req
            if not item.done.is_set():
                self._fail(item, "server stopped")

    def stats(self) -> dict:
        with self._lock:
            queued, active = len(self._queue), len(self._active)
            submitted, rejected = self.submitted, self.rejected
        return {
            "submitted": submitted,
            "completed": self.completed,
            "rejected": rejected,
            "failed": self.failed,
            "queued": queued,
            "active": active,
            "max_active": self.max_active,
            "queue_size": self.queue_size,
            "tokens_generated": self.tokens_generated,
            "prefills_dispatched": self.prefills_dispatched,
            "window_ladder": list(self.window_ladder),
            "windows_dispatched": dict(self.windows_dispatched),
            "windows_pipelined": self.windows_pipelined,
            "speculative": self.speculative,
            "spec_ladder": list(self.spec_ladder),
            "spec_k": self.spec_k,
            "spec_windows_dispatched": dict(self.spec_windows_dispatched),
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_rows_verified": self.spec_rows_verified,
            "draft_prefills_dispatched": self.draft_prefills_dispatched,
            "draft_prefill_failures": self.draft_prefill_failures,
        }
