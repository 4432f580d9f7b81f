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

Backpressure: the submit queue is bounded, and a full queue raises
:class:`QueueFullError` at once (HTTP 429). The active set is bounded by
``max_active`` (at most the cache's slots). The scheduler is
single-threaded: ``step`` runs on the server's background thread (``run``)
or directly from tests (``drain``); ``submit`` may be called from any
thread.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

import numpy as np

from .engine import GREEDY, PAD_TOKEN, DecodeWindow, SamplingParams, ServeEngine
from .state_cache import PREFIX_SID_NAMESPACE


class QueueFullError(RuntimeError):
    """Admission control: the bounded submit queue is full (HTTP 429)."""


class Request:
    """One generation request; the scheduler fills the result fields and
    publishes them by setting ``done``. ``session_id`` continues a kept
    session (``None``: a new one, whose id the scheduler mints and writes
    back here); ``keep_session`` keeps the session's state after this
    request; ``use_prefix=False`` neither reads nor inserts prefix-cache
    entries."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens: int, *,
                 sampling: SamplingParams = GREEDY,
                 session_id: str | None = None,
                 keep_session: bool = False,
                 eos_id: int | None = None,
                 use_prefix: bool = True):
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
    #: default speculative K_draft ladder; rung 0 (plain decode) is always
    #: present
    DEFAULT_SPEC_LADDER = (0, 2, 4)

    def __init__(self, engine: ServeEngine, *, max_active: int = 16,
                 queue_size: int = 64,
                 window_ladder: tuple[int, ...] = DEFAULT_WINDOW_LADDER,
                 prefill_chunk: int | None = None,
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
        self.prefill_chunk = prefill_chunk
        self._queue: deque[Request] = deque()
        # admitted sessions still consuming their prompt (FIFO; the
        # scheduler thread's — the lock covers reads from stats())
        self._prefilling: list[_Prefilling] = []
        self._active: list[_Session] = []
        # the in-flight window and its rows (scheduler thread only)
        self._pending: tuple[DecodeWindow, list[_Session]] | None = None
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._sid_counter = itertools.count()
        # minted session ids carry a per-process random part: a restarted
        # server on the same session directory must not mint an id whose
        # file an earlier process wrote
        self._sid_prefix = f"s0.{os.urandom(3).hex()}"
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0
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

    # ---- client side ---------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a request, or raise: ``ValueError`` for one the engine
        cannot serve (prompt too long without ``prefill_chunk``, a token id
        outside the vocabulary, unsupported sampling),
        :class:`QueueFullError` when the bounded queue is full. The id check
        keeps a bad id from reaching the embedding gather, where on the
        card it would be a device-side assert that leaves the CUDA context,
        and so the server, unusable."""
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
            if len(self._queue) >= self.queue_size:
                self.rejected += 1
                raise QueueFullError(
                    f"submit queue full ({self.queue_size} pending)")
            req.t_submit = time.perf_counter()
            self.submitted += 1
            self._queue.append(req)
            self._work.notify()

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
        did = self._admit()
        did = self._prefill_step() or did
        did = self._decode_all() or did
        self.last_heartbeat = time.monotonic()
        return did

    def _admit(self) -> bool:
        admit: list[Request] = []
        dropped: list[Request] = []
        with self._lock:
            busy = {s.sid for s in self._active}
            busy.update(p.sess.sid for p in self._prefilling)
            capacity = min(
                self.max_active - len(self._active) - len(self._prefilling),
                self.engine.max_batch)
            while self._queue and len(admit) < capacity:
                head = self._queue[0]
                if head.cancelled:
                    self._queue.popleft()
                    dropped.append(head)
                    continue
                # one admission batch is one sampling config; FIFO at the
                # head keeps admission starvation-free
                if admit and head.sampling.key() != admit[0].sampling.key():
                    break
                admit.append(self._queue.popleft())
        for r in dropped:
            self._fail(r, "cancelled before admission")
        if not admit:
            return bool(dropped)
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
        for p in list(self._prefilling):
            if p.sess.req.cancelled:
                self._abort_prefilling(p, "cancelled during prefill")
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
        try:
            if final:
                first = self.engine.prefill(items, batch[0].sess.req.sampling)
                self.prefills_dispatched += 1
            else:
                self.engine.prefill_chunk(items)
                self.prefill_chunks_dispatched += 1
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
            self._append_token(s, int(first[i]), now)
            if s.remaining == 0:
                self._finish(s)
            else:
                with self._lock:
                    self._active.append(s)

    def _abort_prefilling(self, p: _Prefilling, error: str) -> None:
        with self._lock:
            try:
                self._prefilling.remove(p)
            except ValueError:
                return  # already settled
        if p.entry is not None:
            self.engine.prefix.release(p.entry)
            p.entry = None
        self.engine.cache.release(p.sess.sid)
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
            queue_empty = not self._queue and not self._prefilling
        for s in active:
            if s.req.cancelled:  # abandoned mid-decode: free the slot now
                self._retire(s)
                self.engine.cache.release(s.sid)
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
            queue_empty = not self._queue and not self._prefilling
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
            self.engine.cache.release(s.sid)
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
        s.req.done.set()

    def _fail(self, req: Request, error: str) -> None:
        req.error = error
        req.t_done = time.perf_counter()
        self.failed += 1
        req.done.set()

    # ---- run loops ---------------------------------------------------------

    def warmup(self, sampling: SamplingParams = GREEDY,
               prompt_lens: tuple[int, ...] = (1,)) -> int:
        """Warm everything this scheduler can dispatch for these prompt
        lengths. The chunk and prefix-insert split lengths are scheduler
        policy, so this replays :meth:`_stop_from`'s stops for each length
        — a cold fresh prompt, a fresh prompt resumed from any prefix hit,
        a continuation fragment — and warms the union of final and intermediate lengths, every
        window-ladder rung and, when speculative, the draft prefills and
        every spec-ladder rung, for every batch bucket."""
        finals: set[int] = set()
        chunks: set[int] = set()
        prefix = self.engine.prefix
        chunk = self.prefill_chunk
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
                if (not self._queue and not self._active
                        and not self._prefilling):
                    self._work.wait(timeout=idle_wait)
            self.last_heartbeat = time.monotonic()
        if self._pending is not None:
            # deliver the in-flight window's tokens; dispatch nothing more
            self._resolve_pending(pipeline=False)
        for p in list(self._prefilling):
            self._abort_prefilling(p, "server stopped during prefill")
        with self._lock:
            leftovers = list(self._active) + list(self._queue)
            self._queue.clear()
        for item in leftovers:
            if isinstance(item, _Session):
                self._retire(item)
                self.engine.cache.release(item.sid)
                item = item.req
            if not item.done.is_set():
                self._fail(item, "server stopped")

    def stats(self) -> dict:
        with self._lock:
            queued, active = len(self._queue), len(self._active)
            prefilling = len(self._prefilling)
            submitted, rejected = self.submitted, self.rejected
        return {
            "submitted": submitted,
            "completed": self.completed,
            "rejected": rejected,
            "failed": self.failed,
            "queued": queued,
            "active": active,
            "prefilling": prefilling,
            "max_active": self.max_active,
            "queue_size": self.queue_size,
            "tokens_generated": self.tokens_generated,
            "prefills_dispatched": self.prefills_dispatched,
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks_dispatched": self.prefill_chunks_dispatched,
            "prefix_resumed": self.prefix_resumed,
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "prefill_tokens_computed": self.prefill_tokens_computed,
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
