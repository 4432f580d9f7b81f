"""Slot-based device-resident cache of per-session recurrent state, and
the stores layered on it.

Port of ``lstm_tensorspark_tpu/serve/state_cache.py``. An LSTM session's
whole decode state is ``(h, c)`` per layer, fixed-size whatever the session
has consumed. :class:`StateCache` holds it as two device tensors
``[L, S+1, H]`` float32 plus a host-side session table:

- sessions map to integer **slots**; the engine gathers carries by slot
  (``index_select``), runs the step and scatters the results back
  (``index_copy_``) — in place, in stream order, where the JAX package
  threads immutable arrays through its programs;
- slot ``S`` (the last row) is a **scratch slot**: batches padded up to a
  bucket point their dead rows at it, so padding never touches a live
  session;
- **LRU eviction** frees the least-recently-used unpinned slot when the
  cache is full; the batcher pins the slots of active sessions, so only
  idle (kept) sessions and prefix entries are ever evicted. Eviction
  listeners (the prefix cache, the session tiers) fire under the cache
  lock;
- **detach / restore** move a session's carries to host numpy and back,
  exactly (float32 both ways).

Because the cache is written in place, a reference to its rows taken now
would read whatever a later prefill writes there. So every capture of a
slot (:meth:`StateCache.capture`: an eviction's spill, a request-boundary
checkpoint, a detach) is a device-side copy of the rows, enqueued on the
serving stream ahead of any reuse of the slot, with a CUDA event recorded
behind it. Readers wait on that event alone.

:class:`PrefixCache` stores "state after token prefix P" entries, each
backed by a slot under the reserved ``prefix/`` session namespace.
:class:`SessionTiers` keeps evicted sessions in host RAM and in a
sha256-verified disk tier (one file a session, the JAX package's name
scheme and byte layout) and fills them back into a slot.

``generation`` counts device updates applied to the cache, so
``tokens_generated / generation`` shows the effective window size.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..train.checkpoint import CorruptCheckpointError, atomic_write, read_verified

#: session-id namespace of the prefix cache's backing slots. A client
#: naming one would inherit (and corrupt) the shared prefix state, so the
#: batcher's ``Request`` refuses ids under it.
PREFIX_SID_NAMESPACE = "prefix/"

#: configuration keys of a prefix store's ``stats()``: a sum over stores
#: (the load generator's ``prefix_totals``) keeps the first store's value
#: for these and adds the rest (the JAX package's tuple, its radix store's
#: keys included)
PREFIX_STATS_CONFIG_KEYS = ("stride", "max_entries", "max_nodes",
                            "host_bytes", "state_bytes", "mode")


class CacheFullError(RuntimeError):
    """No free slot and every occupied slot is pinned."""


class DetachedState(NamedTuple):
    """Host-resident session state: h, c each ``[L, H]`` float32 numpy."""

    h: np.ndarray
    c: np.ndarray


class Capture(NamedTuple):
    """A device-side copy of one slot's rows: h, c each ``[L, H]``, valid
    once ``ready`` (a CUDA event; None on the CPU, where the copy is done
    when it returns) has completed."""

    h: torch.Tensor
    c: torch.Tensor
    ready: object


class StateCache:
    def __init__(self, num_layers: int, num_slots: int, hidden_size: int,
                 device: torch.device, registry=None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_layers = num_layers
        self.num_slots = num_slots
        self.hidden_size = hidden_size
        self.device = torch.device(device)
        # +1: the scratch slot for padded batch rows (index == num_slots)
        shape = (num_layers, num_slots + 1, hidden_size)
        self.h = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.c = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._lock = threading.RLock()
        self._slots: OrderedDict[str, int] = OrderedDict()  # LRU: oldest first
        self._free: list[int] = list(range(num_slots))
        self._pinned: set[str] = set()
        self.evictions = 0
        self.generation = 0  # device updates applied to h/c
        # called under the cache lock with the (sid, slot) of every
        # LRU-evicted session: the prefix cache invalidates or spills the
        # dependent entry, the session tiers capture the evicted rows
        self.evict_listeners: list = []
        # /metrics mirrors of the ints above (which stay this instance's
        # stats()); the JAX package's family names and help strings
        reg = obs.REGISTRY if registry is None else registry
        self._m_evictions = reg.counter(
            "serve_state_cache_evictions_total",
            "LRU evictions of unpinned session slots")
        self._m_swaps = reg.counter(
            "serve_state_cache_swaps_total",
            "device programs applied to the cache arrays (generation)")

    @property
    def scratch_slot(self) -> int:
        return self.num_slots

    # ---- session table -------------------------------------------------

    def lookup(self, session_id: str) -> int | None:
        """Slot of a live session (refreshes its LRU recency), else None."""
        with self._lock:
            if session_id not in self._slots:
                return None
            self._slots.move_to_end(session_id)
            return self._slots[session_id]

    def acquire(self, session_id: str) -> tuple[int, bool]:
        """``(slot, fresh)`` for the session, allocating if needed.
        ``fresh`` means the slot holds no prior state for the session — the
        engine's prefill starts such rows from zero carries itself."""
        with self._lock:
            if session_id in self._slots:
                self._slots.move_to_end(session_id)
                return self._slots[session_id], False
            slot = self._free.pop() if self._free else self._evict_lru_locked()
            self._slots[session_id] = slot
            return slot, True

    def acquire_pinned(self, session_id: str) -> tuple[int, bool]:
        """:meth:`acquire` and :meth:`pin` under one lock hold."""
        with self._lock:
            slot, fresh = self.acquire(session_id)
            self._pinned.add(session_id)
            return slot, fresh

    def _evict_lru_locked(self) -> int:
        for sid in self._slots:  # oldest recency first
            if sid not in self._pinned:
                slot = self._slots.pop(sid)
                self.evictions += 1
                self._m_evictions.inc()
                for listener in self.evict_listeners:
                    listener(sid, slot)
                return slot
        raise CacheFullError(f"all {self.num_slots} slots pinned by active "
                             "sessions")

    def release(self, session_id: str) -> None:
        """Drop the session; its slot returns to the free list. No-op for
        unknown sessions (release after eviction is safe)."""
        with self._lock:
            self._pinned.discard(session_id)
            slot = self._slots.pop(session_id, None)
            if slot is not None:
                self._free.append(slot)

    def rename(self, session_id: str, new_id: str) -> bool:
        """Move a live session's slot to ``new_id``, pinned (the batcher
        parks a timed-out row's slot this way until the window still
        writing it is fetched). False when ``session_id`` holds no slot."""
        with self._lock:
            slot = self._slots.pop(session_id, None)
            if slot is None:
                return False
            self._pinned.discard(session_id)
            self._slots[new_id] = slot
            self._pinned.add(new_id)
            return True

    def pin(self, session_id: str) -> None:
        with self._lock:
            if session_id not in self._slots:
                raise KeyError(f"cannot pin unknown session {session_id!r}")
            self._pinned.add(session_id)

    def unpin(self, session_id: str) -> None:
        with self._lock:
            self._pinned.discard(session_id)

    def is_pinned(self, session_id: str) -> bool:
        with self._lock:
            return session_id in self._pinned

    def __contains__(self, session_id: str) -> bool:
        with self._lock:
            return session_id in self._slots

    def session_ids(self) -> list[str]:
        """Live session ids, LRU-oldest first (the ``prefix/`` namespace
        included)."""
        with self._lock:
            return list(self._slots)

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    # ---- device state --------------------------------------------------

    def _index(self, slots) -> torch.Tensor:
        """Slot indices as an int64 tensor on the cache's device."""
        if isinstance(slots, torch.Tensor):
            return slots.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(slots, np.int64).reshape(-1),
                               device=self.device)

    def _rows(self, x) -> torch.Tensor:
        """Carries ``[L, B, H]`` (a tensor or numpy) as float32 on the
        cache's device (a host array is one host-to-device copy)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    def read_slots(self, slots):
        """Gather carries for ``slots`` [B] → ``(h, c)`` each [L, B, H]
        (copies, so a later write to the slots does not reach them)."""
        idx = self._index(slots)
        return self.h.index_select(1, idx), self.c.index_select(1, idx)

    def write_slots(self, slots, h, c) -> None:
        """Scatter ``(h, c)`` each [L, B, H] into ``slots`` [B], in place.
        Padding rows all point at the scratch slot, so the only duplicate
        indices a batch carries are scratch rows, whose contents nothing
        reads — which duplicate lands there does not matter."""
        idx = self._index(slots)
        self.h.index_copy_(1, idx, self._rows(h))
        self.c.index_copy_(1, idx, self._rows(c))
        with self._lock:
            self.generation += 1
        self._m_swaps.inc()

    def gather_scatter(self, dst_slots, src_h, src_c, src_slots) -> None:
        """Gather rows ``src_slots`` of ``src_h``/``src_c`` (``[L, S', H]``
        device tensors: this cache's own, or a stack of captures) and
        scatter them into ``dst_slots``. The gather copies first, so a
        source that is this cache is read before any of its rows is
        written."""
        src = self._index(src_slots)
        self.write_slots(dst_slots, src_h.index_select(1, src),
                         src_c.index_select(1, src))

    def copy_slot(self, src: int, dst: int) -> None:
        """On-device copy of one slot's carries (``src`` read, ``dst``
        written) — how a prefix entry snapshots a session's state. In
        stream order, so after any enqueued work that writes ``src``."""
        self.gather_scatter([dst], self.h, self.c, [src])

    def capture(self, slot: int) -> Capture:
        """Copy one slot's rows on the device, on the current stream, and
        record an event behind the copy: the capture stays the slot's
        state now, whatever later work writes the slot."""
        h = self.h[:, slot, :].clone()
        c = self.c[:, slot, :].clone()
        ready = None
        if h.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(h.device))
        return Capture(h, c, ready)

    # ---- detach / restore ----------------------------------------------

    @staticmethod
    def fetch_detached(h: torch.Tensor, c: torch.Tensor) -> DetachedState:
        """Blocking device→host copy of one session's ``[L, H]`` rows."""
        return DetachedState(h=h.detach().to("cpu").numpy().copy(),
                             c=c.detach().to("cpu").numpy().copy())

    _copy_streams: dict = {}

    @classmethod
    def fetch_detached_batch(cls, captures) -> list[DetachedState]:
        """Host copies of many :class:`Capture` s: wait on each capture's
        event (never on the whole device), then copy every pair to pinned
        host memory on a side stream, and wait for that stream once. The
        side stream keeps the copies out of the serving stream's order, so
        they never wait behind a decode window enqueued after the
        capture."""
        captures = list(captures)
        if not captures or not captures[0].h.is_cuda:
            return [cls.fetch_detached(cap.h, cap.c) for cap in captures]
        device = captures[0].h.device
        stream = cls._copy_streams.get(device)
        if stream is None:
            stream = cls._copy_streams.setdefault(device,
                                                  torch.cuda.Stream(device))
        hosts = []
        with torch.cuda.stream(stream):
            for cap in captures:
                stream.wait_event(cap.ready)
                hh = torch.empty(cap.h.shape, dtype=torch.float32,
                                 pin_memory=True)
                hc = torch.empty(cap.c.shape, dtype=torch.float32,
                                 pin_memory=True)
                hh.copy_(cap.h, non_blocking=True)
                hc.copy_(cap.c, non_blocking=True)
                hosts.append((hh, hc))
        stream.synchronize()
        return [DetachedState(h=hh.numpy().copy(), c=hc.numpy().copy())
                for hh, hc in hosts]

    def detach(self, session_id: str) -> DetachedState:
        """Pull a session's carries to host and release its slot. Exact
        (float32 both ways): restoring it and continuing decode is
        token-identical to never having detached."""
        with self._lock:
            if session_id not in self._slots:
                raise KeyError(f"cannot detach unknown session {session_id!r}")
            cap = self.capture(self._slots[session_id])
            self.release(session_id)
        # the blocking host copy runs outside the (scheduler-shared) lock
        return self.fetch_detached_batch([cap])[0]

    def restore(self, session_id: str, state: DetachedState) -> int:
        """Re-admit a detached session; returns its (new) slot."""
        if state.h.shape != (self.num_layers, self.hidden_size):
            raise ValueError(
                f"detached state shape {state.h.shape} does not match cache "
                f"({self.num_layers}, {self.hidden_size})")
        with self._lock:
            if session_id in self._slots:
                raise ValueError(f"session {session_id!r} already live")
            slot, _ = self.acquire(session_id)
            self.write_slots([slot], state.h[:, None, :], state.c[:, None, :])
            return slot

    def stats(self) -> dict:
        with self._lock:
            return {
                "slots": self.num_slots,
                "live_sessions": len(self._slots),
                "pinned": len(self._pinned),
                "free": len(self._free),
                "evictions": self.evictions,
                "generation": self.generation,
            }


class PrefixEntry:
    """One cached prefix: the exact token prefix, its backing state-cache
    session/slot, and a refcount of in-flight prefills reading it.
    ``slot`` is None while the entry is SPILLED (its backing slot was
    evicted under a tiered cache; the state lives in the host tier until a
    lookup promotes it back)."""

    __slots__ = ("key", "length", "sid", "slot", "refs")

    def __init__(self, key: bytes, length: int, sid: str, slot: int | None):
        self.key = key
        self.length = length
        self.sid = sid
        self.slot = slot
        self.refs = 0


class PrefixCache:
    """Shared-prompt prefix store over the :class:`StateCache`.

    An LSTM's state after any prefix is one ``(h, c)`` pair per layer, so
    exact prefix reuse is a slot copy. Entries are keyed by the exact token
    bytes of the prefix and live at ``stride``-aligned lengths, so
    :meth:`lookup` probes the few distinct entry lengths longest-first.
    Each entry owns a state-cache slot under the ``prefix/`` namespace:

    - **refcounting**: ``lookup`` pins the backing slot and bumps ``refs``
      until the resumed prefill has been *dispatched* (:meth:`release`):
      the engine's gather from the slot is enqueued by then, and stream
      order covers the rest. A prefix slot is only ever read: a resumed
      prefill gathers from it and writes the session's own slot;
    - **LRU eviction**: a full prefix cache evicts its own oldest zero-ref
      entry; a state-cache eviction of a backing slot **invalidates** the
      entry (or, with tiers, **spills** it);
    - a matched length is capped at ``len(prompt) - 1``: at least one
      prompt token is always prefilled, so the first token comes from the
      same head math as a cold run.

    Shares the state cache's reentrant lock: the eviction listener fires
    under it, and a private lock would deadlock against ``acquire`` /
    ``pin`` calls made from here.
    """

    def __init__(self, cache: StateCache, *, stride: int = 8,
                 max_entries: int = 16, tiers=None, registry=None):
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.cache = cache
        self.stride = stride
        self.max_entries = max_entries
        self.tiers: SessionTiers | None = tiers
        self._lock = cache._lock  # shared on purpose (see docstring)
        self._entries: OrderedDict[bytes, PrefixEntry] = OrderedDict()
        self._by_sid: dict[str, bytes] = {}
        # distinct entry lengths, longest first, with a count per length
        self._lengths_desc: list[int] = []
        self._length_counts: dict[int, int] = {}
        self._sid_counter = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0     # own LRU (full prefix cache)
        self.invalidated = 0   # backing slot evicted, state lost
        self.spilled = 0       # backing slot evicted, state kept in a tier
        self.promoted = 0      # spilled entry restored to a device slot
        reg = obs.REGISTRY if registry is None else registry
        fam = reg.counter(
            "serve_prefix_cache_events_total",
            "prefix-cache outcomes (hit/miss/insert/evict/invalidate/"
            "spill/promote)",
            labelnames=("event",))
        self._m = {e: fam.labels(event=e)
                   for e in ("hit", "miss", "insert", "evict", "invalidate",
                             "spill", "promote")}
        cache.evict_listeners.append(self._on_slot_evicted_locked)

    @staticmethod
    def _key(tokens) -> bytes:
        return np.asarray(tokens, np.int32).tobytes()

    def boundary(self, length: int) -> int:
        """Largest cacheable prefix length of a ``length``-token prompt:
        stride-aligned and <= length - 1. 0: too short to cache."""
        k = ((length - 1) // self.stride) * self.stride
        return k if k >= self.stride else 0

    def _length_add_locked(self, n: int) -> None:
        count = self._length_counts.get(n, 0)
        self._length_counts[n] = count + 1
        if count == 0:
            self._lengths_desc.append(n)
            self._lengths_desc.sort(reverse=True)

    def _length_drop_locked(self, n: int) -> None:
        count = self._length_counts.get(n, 0) - 1
        if count > 0:
            self._length_counts[n] = count
            return
        self._length_counts.pop(n, None)
        if n in self._lengths_desc:
            self._lengths_desc.remove(n)

    def lookup(self, prompt) -> tuple[PrefixEntry | None, int]:
        """Longest exact-prefix match of ``prompt`` with matched length
        <= len(prompt) - 1. A hit returns ``(entry, matched_len)`` with the
        entry ref-held and its slot pinned — the caller MUST
        :meth:`release` after dispatching the resumed prefill."""
        p = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            # a snapshot: a probe can drop an entry (a failed promotion)
            for n in list(self._lengths_desc):
                if n > p.size - 1:
                    continue
                entry = self._entries.get(self._key(p[:n]))
                if entry is None:
                    continue
                if entry.slot is None and not self._promote_locked(entry):
                    continue  # its spilled state is gone: probe shorter
                self._entries.move_to_end(entry.key)
                # the backing slot's state-cache recency too
                self.cache.lookup(entry.sid)
                if entry.refs == 0:
                    self.cache.pin(entry.sid)
                entry.refs += 1
                self.hits += 1
                self._m["hit"].inc()
                return entry, entry.length
            self.misses += 1
            self._m["miss"].inc()
            return None, 0

    def _promote_locked(self, entry: PrefixEntry) -> bool:
        """Restore a SPILLED entry's state from the tiers into a fresh
        slot. False (and the entry dropped) when the tiered state is gone;
        False, entry kept, when no slot can be had now (all pinned)."""
        try:
            slot, fresh = self.cache.acquire(entry.sid)
        except CacheFullError:
            return False
        # memory tiers only: this runs under the shared lock, and prefix
        # states never reach the disk tier
        if fresh and (self.tiers is None
                      or not self.tiers.fill_memory(entry.sid, slot)):
            self.cache.release(entry.sid)
            self._by_sid.pop(entry.sid, None)
            if self._entries.pop(entry.key, None) is not None:
                self._length_drop_locked(entry.length)
            self.invalidated += 1
            self._m["invalidate"].inc()
            return False
        entry.slot = slot
        self.promoted += 1
        self._m["promote"].inc()
        return True

    def release(self, entry: PrefixEntry) -> None:
        """Drop one ref; the last ref unpins the backing slot. Safe after
        invalidation."""
        with self._lock:
            if entry.refs > 0:
                entry.refs -= 1
            if entry.refs == 0 and self._by_sid.get(entry.sid) == entry.key:
                self.cache.unpin(entry.sid)

    def insert(self, tokens, src_slot: int) -> bool:
        """Snapshot the state in ``src_slot`` (the state after exactly
        ``tokens``) into a new entry. Returns False — never raises — when
        the entry exists, every entry is ref-held, or no slot is left:
        prefix caching degrades, it never fails a request."""
        key = self._key(tokens)
        length = int(np.asarray(tokens).size)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.cache.lookup(self._entries[key].sid)
                return False
            while len(self._entries) >= self.max_entries:
                victim = next(
                    (e for e in self._entries.values() if e.refs == 0), None)
                if victim is None:
                    return False  # every entry is mid-use
                self._evict_entry_locked(victim)
            self._sid_counter += 1
            sid = f"{PREFIX_SID_NAMESPACE}{self._sid_counter}"
            try:
                slot, _ = self.cache.acquire(sid)
            except CacheFullError:
                return False
            self.cache.copy_slot(src_slot, slot)
            entry = PrefixEntry(key, length, sid, slot)
            self._entries[key] = entry
            self._by_sid[sid] = key
            self._length_add_locked(length)
            self.inserts += 1
            self._m["insert"].inc()
            return True

    def _evict_entry_locked(self, entry: PrefixEntry) -> None:
        if self._entries.pop(entry.key, None) is not None:
            self._length_drop_locked(entry.length)
        self._by_sid.pop(entry.sid, None)
        self.cache.release(entry.sid)
        if self.tiers is not None:
            self.tiers.discard_memory(entry.sid)
        self.evictions += 1
        self._m["evict"].inc()

    def _on_slot_evicted_locked(self, sid: str, slot: int) -> None:
        # the state cache's LRU took a backing slot. Untiered: the entry
        # is garbage, drop it. Tiered: the tiers' listener captured the
        # rows, so the entry survives SPILLED (slot None)
        key = self._by_sid.get(sid)
        if key is None:
            return
        entry = self._entries.get(key)
        if self.tiers is not None and entry is not None:
            entry.slot = None
            self.spilled += 1
            self._m["spill"].inc()
            return
        self._by_sid.pop(sid, None)
        dropped = self._entries.pop(key, None)
        if dropped is not None:
            self._length_drop_locked(dropped.length)
        self.invalidated += 1
        self._m["invalidate"].inc()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "mode": "exact",
                "entries": len(self._entries),
                "stride": self.stride,
                "max_entries": self.max_entries,
                "hits": self.hits,
                "misses": self.misses,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "invalidated": self.invalidated,
                "spilled": self.spilled,
                "promoted": self.promoted,
            }


class _SpillJob:
    """A spill in flight: the :class:`Capture` of the evicted (or
    checkpointed) slot, its destinations, and whether a worker queue entry
    still points here."""

    __slots__ = ("cap", "t0", "to_host", "to_disk", "in_queue")

    def __init__(self, cap: Capture, t0: float, *, to_host: bool,
                 to_disk: bool):
        self.cap = cap
        self.t0 = t0
        self.to_host = to_host
        self.to_disk = to_disk
        self.in_queue = False


def session_file_path(directory: str, sid: str) -> str:
    """The disk tier's file of a session: session ids are client strings,
    so the name is a digest and the sid lives in the file's JSON header
    (the JAX package's scheme, so either package reads the other's
    files)."""
    digest = hashlib.sha256(sid.encode()).hexdigest()[:24]
    return os.path.join(directory, f"sess-{digest}{_DiskTier.SUFFIX}")


class _DiskTier:
    """Durable session files under one directory: a JSON header line
    (sid, layers, hidden, dtype, the state's sha256) then float32 ``h``
    and ``c``, written by ``atomic_write`` (fsync, then rename). A file
    that fails its hash or cannot be parsed is QUARANTINED (renamed
    ``*.quarantined``) and reported as state lost — never served as wrong
    tokens. A startup scan rebuilds the sid → file index, so a restarted
    server serves every session the previous process wrote. A private
    lock guards only the index; file IO runs outside it."""

    SUFFIX = ".state"

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._index: dict[str, str] = {}
        self._scan()

    def _scan(self) -> None:
        for name in sorted(os.listdir(self.directory)):
            if not name.endswith(self.SUFFIX):
                continue
            path = os.path.join(self.directory, name)
            try:
                with open(path, "rb") as f:
                    meta = json.loads(f.readline())
                sid = meta["sid"]
                if not isinstance(sid, str):
                    raise ValueError(f"bad sid {sid!r}")
            except (OSError, ValueError, KeyError, TypeError):
                self._quarantine(None, path)
                continue
            with self._lock:
                self._index[sid] = path

    def _path(self, sid: str) -> str:
        return session_file_path(self.directory, sid)

    def _quarantine(self, sid: str | None, path: str) -> None:
        for p in (path, path + ".sha256"):
            try:
                os.replace(p, p + ".quarantined")
            except OSError:
                pass  # a vanished file is already gone
        if sid is not None:
            with self._lock:
                self._index.pop(sid, None)

    def has_indexed(self, sid: str) -> bool:
        """Index-only probe: no filesystem IO, safe under hot locks."""
        with self._lock:
            return sid in self._index

    def has(self, sid: str) -> bool:
        with self._lock:
            if sid in self._index:
                return True
        # another process may have written it after the startup scan: the
        # name follows from the sid, so one stat finds it
        path = self._path(sid)
        if os.path.exists(path):
            with self._lock:
                self._index[sid] = path
            return True
        return False

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def put(self, sid: str, state: DetachedState) -> None:
        body = (state.h.astype(np.float32).tobytes()
                + state.c.astype(np.float32).tobytes())
        meta = {"sid": sid, "layers": int(state.h.shape[0]),
                "hidden": int(state.h.shape[1]), "dtype": "float32",
                "sha256": hashlib.sha256(body).hexdigest()}
        path = self._path(sid)
        atomic_write(path, json.dumps(meta).encode() + b"\n" + body)
        with self._lock:
            self._index[sid] = path

    def get(self, sid: str, num_layers: int,
            hidden_size: int) -> DetachedState | None:
        """Read and verify one session file. None: not present; raises
        :class:`CorruptCheckpointError` after quarantining a file that
        exists but cannot be trusted."""
        with self._lock:
            path = self._index.get(sid)
        if path is None:
            cand = self._path(sid)
            if not os.path.exists(cand):
                return None
            path = cand
            with self._lock:
                self._index[sid] = path
        try:
            data = read_verified(path)
        except CorruptCheckpointError:
            self._quarantine(sid, path)
            raise
        except OSError:
            # vanished or unreadable: a miss, not corruption
            with self._lock:
                self._index.pop(sid, None)
            return None
        try:
            head, _, body = data.partition(b"\n")
            meta = json.loads(head)
            n = num_layers * hidden_size * 4
            if meta.get("sid") != sid or len(body) != 2 * n:
                raise ValueError(
                    f"session payload mismatch (sid {meta.get('sid')!r}, "
                    f"{len(body)} state bytes, expected {2 * n})")
            got = hashlib.sha256(body).hexdigest()
            if meta.get("sha256") != got:
                raise ValueError(
                    f"state sha256 mismatch (header "
                    f"{str(meta.get('sha256'))[:12]}…, got {got[:12]}…) — "
                    "truncated or corrupted write")
            h = np.frombuffer(body[:n], np.float32).reshape(
                num_layers, hidden_size).copy()
            c = np.frombuffer(body[n:], np.float32).reshape(
                num_layers, hidden_size).copy()
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            self._quarantine(sid, path)
            raise CorruptCheckpointError(f"{path}: {e}") from e
        return DetachedState(h=h, c=c)

    def discard(self, sid: str) -> None:
        with self._lock:
            path = self._index.pop(sid, None)
        if path is not None:
            for p in (path, path + ".sha256"):
                try:
                    os.remove(p)
                except OSError:
                    pass


class _Seconds:
    """Count, sum and largest of a latency, in seconds."""

    __slots__ = ("count", "sum", "max")

    def __init__(self):
        self.count, self.sum, self.max = 0, 0.0, 0.0

    def add(self, seconds: float, n: int = 1) -> None:
        self.count += n
        self.sum += seconds * n
        self.max = max(self.max, seconds)

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.sum, "max": self.max}


class SessionTiers:
    """Host-RAM and disk tiers under the device :class:`StateCache`.

    Device slots stay tier 0. When the cache LRU-evicts an idle session,
    the eviction listener (under the cache lock, on the thread that
    acquired the slot) enqueues a :meth:`StateCache.capture` of the
    evicted rows — a device copy on the serving stream ahead of any reuse
    of the slot, an event behind it — and an ASYNC spill job. A worker
    thread drains the jobs in batches: it waits on each capture's event
    (never on the whole device, never on the scheduler thread), copies the
    rows to host RAM, and stores them in the host tier. Host overflow
    cascades the oldest entry to the disk tier (:class:`_DiskTier`), or
    drops it honestly when no directory is configured.

    **Fill** is the reverse: a continuation of a spilled session restores
    its state into a freshly acquired, pinned slot — from the pending
    capture (device to device: the host copy never had to happen), the
    host tier (one host-to-device copy), or a verified disk read.

    **Checkpoint**: :meth:`checkpoint` (the batcher calls it when a
    ``keep_session`` request completes) write-behinds the session's
    request-boundary state to the disk tier. Sessions are evictable only
    while idle, and idle state is the last request boundary, so a file is
    never stale while its session is fillable: a server killed and
    restarted on the same directory resumes every checkpointed session
    token-identically. The durability boundary is the last completed
    request whose write landed (:meth:`flush`; ``ServeServer.stop``
    flushes).

    Shares the state cache's reentrant lock (the eviction listener fires
    under it). The worker copies and writes files outside it."""

    #: most spill jobs the worker takes in one batch
    SPILL_BATCH = 64

    def __init__(self, cache: StateCache, *, host_entries: int = 256,
                 directory: str | None = None, registry=None):
        if host_entries < 1:
            raise ValueError(f"host_entries must be >= 1, got {host_entries}")
        self.cache = cache
        self.host_entries = host_entries
        self._lock = cache._lock  # shared on purpose (see docstring)
        self._work = threading.Condition(self._lock)
        self._pending: dict[str, _SpillJob] = {}
        self._queue: deque[str] = deque()
        self._host: OrderedDict[str, DetachedState] = OrderedDict()
        # host-overflow victims whose disk write is in flight: fillable
        # here until it lands
        self._evacuating: dict[str, DetachedState] = {}
        # sids discarded while a disk flush runs: the flusher deletes any
        # file it just wrote for them
        self._dropped: set[str] = set()
        self._flushing = 0
        self._disk = _DiskTier(directory) if directory else None
        self._thread: threading.Thread | None = None
        self._closed = False  # close() parks the worker; enqueue revives
        self._in_flight = 0
        self.spills = {"host": 0, "disk": 0}
        self.fills = {"host": 0, "disk": 0}
        # the host fills made from a pending capture, device to device
        self.fills_pending = 0
        self.misses = 0
        self.corrupt = 0
        self.lost = 0  # host overflow dropped without a disk tier
        self.disk_errors = 0  # failed disk writes (state kept in RAM)
        # eviction (or checkpoint) → state stored, and probe → state
        # written into a slot, in seconds
        self.spill_seconds = _Seconds()
        self.fill_seconds = _Seconds()
        self._bind_metrics(obs.REGISTRY if registry is None else registry)
        cache.evict_listeners.append(self._on_slot_evicted_locked)

    def _bind_metrics(self, reg) -> None:
        """Resolve the labelled instruments once (the record sites read
        them without the lock); ``replica`` is the stack's one, 0."""
        rl = "0"
        fam = reg.counter(
            "serve_tier_spills_total",
            "session states spilled into a tier (host = RAM spill of an "
            "evicted slot; disk = durable session file written)",
            labelnames=("tier", "replica"))
        self._m_spill = {t: fam.labels(tier=t, replica=rl)
                         for t in ("host", "disk")}
        fam = reg.counter(
            "serve_tier_fills_total",
            "spilled session states restored into a device slot, by "
            "source tier",
            labelnames=("tier", "replica"))
        self._m_fill = {t: fam.labels(tier=t, replica=rl)
                        for t in ("host", "disk")}
        fam = reg.counter(
            "serve_tier_lost_total",
            "tier state trouble, by reason (miss = no tier holds it, "
            "corrupt = disk file quarantined, overflow = host tier full "
            "with no disk tier; disk_error = a disk write failed — state "
            "stays in RAM, durability lost, correctness kept)",
            labelnames=("reason", "replica"))
        self._m_lost = {r: fam.labels(reason=r, replica=rl)
                        for r in ("miss", "corrupt", "overflow",
                                  "disk_error")}
        self._m_spill_lat = reg.histogram(
            "serve_tier_spill_seconds",
            "eviction → spilled state stored (device fetch + optional "
            "disk write), per spill job",
            labelnames=("replica",)).labels(replica=rl)
        self._m_fill_lat = reg.histogram(
            "serve_tier_fill_seconds",
            "tier fill: probe → state written back into a device slot",
            labelnames=("replica",)).labels(replica=rl)


    # ---- spill capture (under the cache lock) --------------------------

    def _on_slot_evicted_locked(self, sid: str, slot: int) -> None:
        # prefix states stay in RAM (their entries die with the process)
        to_disk = (self._disk is not None
                   and not sid.startswith(PREFIX_SID_NAMESPACE)
                   and not self._disk.has_indexed(sid))
        self._enqueue_locked(sid, slot, to_host=True, to_disk=to_disk)

    def _enqueue_locked(self, sid: str, slot: int, *, to_host: bool,
                        to_disk: bool) -> None:
        cap = self.cache.capture(slot)
        job = self._pending.get(sid)
        if job is not None:
            # the same request-boundary state (sessions are spillable only
            # while idle): take the newer capture, OR the destinations
            job.cap = cap
            job.to_host = job.to_host or to_host
            job.to_disk = job.to_disk or to_disk
        else:
            job = _SpillJob(cap, time.perf_counter(), to_host=to_host,
                            to_disk=to_disk)
            self._pending[sid] = job
        if not job.in_queue:
            job.in_queue = True
            self._queue.append(sid)
        # no notify: this runs on the admission path, and the worker polls
        self._ensure_worker_locked()

    def _ensure_worker_locked(self) -> None:
        self._closed = False
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self.run, name="serve-tier-spill", daemon=True)
            self._thread.start()

    def close(self) -> None:
        """Park the spill worker (a later enqueue or flush revives it)."""
        with self._work:
            self._closed = True
            self._work.notify_all()

    def checkpoint(self, sid: str) -> bool:
        """Write-behind the session's current (request-boundary) state to
        the disk tier while it stays in its slot. No-op without a disk
        tier or for unknown sids."""
        if self._disk is None:
            return False
        with self._lock:
            slot = self.cache.lookup(sid)
            if slot is None:
                return False
            self._enqueue_locked(sid, slot, to_host=False, to_disk=True)
            return True

    # ---- the spill worker ------------------------------------------------

    def run(self) -> None:
        """Worker loop: drain the spill queue a batch at a time (one wait
        for the host copies of a whole batch)."""
        while True:
            with self._work:
                while not self._queue:
                    if self._closed:
                        return
                    self._work.wait(timeout=0.05)
                batch: list[tuple[str, _SpillJob]] = []
                while self._queue and len(batch) < self.SPILL_BATCH:
                    sid = self._queue.popleft()
                    job = self._pending.get(sid)
                    if job is None or not job.in_queue:
                        continue  # cancelled or superseded
                    job.in_queue = False
                    batch.append((sid, job))
                self._in_flight += len(batch)
            try:
                if batch:
                    self._spill_batch(batch)
            finally:
                # after the disk writes: flush() is a durability barrier
                with self._work:
                    self._in_flight -= len(batch)
                    self._work.notify_all()

    def _spill_batch(self, batch: list[tuple[str, _SpillJob]]) -> None:
        states = self.cache.fetch_detached_batch([job.cap for _, job in batch])
        disk_writes: list[tuple[str, DetachedState]] = []
        stored: list[_SpillJob] = []
        dropped = 0
        with self._work:
            for (sid, job), state in zip(batch, states):
                cur = self._pending.get(sid)
                if cur is not job or job.in_queue:
                    continue  # superseded / re-queued while copying
                del self._pending[sid]
                stored.append(job)
                if job.to_host:
                    self._host[sid] = state
                    self._host.move_to_end(sid)
                    self.spills["host"] += 1
                    self._m_spill["host"].inc()
                    dropped += self._cascade_overflow_locked(disk_writes)
                if job.to_disk:
                    disk_writes.append((sid, state))
        if dropped:
            self._m_lost["overflow"].inc(dropped)
        self._flush_disk_writes(disk_writes)
        end = time.perf_counter()
        with self._lock:
            for job in stored:
                self.spill_seconds.add(end - job.t0)
        for job in stored:
            self._m_spill_lat.observe(end - job.t0)

    def set_host_entries(self, n: int) -> None:
        """Resize the host tier's bound at run time (the serve autotuner's
        capacity knob). Growing is free; shrinking pushes the overflow
        through the spill path's own cascade (disk-bound victims park until
        their write lands, the rest are dropped and counted), the disk
        writes outside the lock."""
        if n < 1:
            raise ValueError(f"host_entries must be >= 1, got {n}")
        disk_writes: list = []
        with self._lock:
            self.host_entries = int(n)
            dropped = self._cascade_overflow_locked(disk_writes)
        if dropped:
            self._m_lost["overflow"].inc(dropped)
        self._flush_disk_writes(disk_writes)

    def _cascade_overflow_locked(self, disk_writes: list) -> int:
        """Pop host-tier overflow victims: disk-bound ones park in
        ``_evacuating`` (still fillable) until their write lands, the rest
        are dropped and counted. Returns the dropped count."""
        dropped = 0
        while len(self._host) > self.host_entries:
            vsid, vstate = self._host.popitem(last=False)
            if (self._disk is not None
                    and not vsid.startswith(PREFIX_SID_NAMESPACE)):
                self._evacuating[vsid] = vstate
                disk_writes.append((vsid, vstate))
            else:
                self.lost += 1
                dropped += 1
        return dropped

    def _flush_disk_writes(self, writes: list) -> None:
        """Write session files outside the shared lock. A write is skipped
        when its session no longer exists anywhere (discarded while
        queued), and a file written while a discard raced it is deleted
        after. A failed write keeps the state in RAM (durability lost,
        correctness kept)."""
        if not writes:
            return
        with self._lock:
            self._flushing += 1
        try:
            for sid, state in writes:
                with self._lock:
                    current = (sid in self._evacuating
                               or sid in self._pending
                               or sid in self._host or sid in self.cache)
                if not current:
                    continue
                try:
                    self._disk.put(sid, state)
                except OSError as e:
                    print(f"serve tiers: disk-tier write failed for "
                          f"{sid!r}: {e}", flush=True)
                    with self._lock:
                        self.disk_errors += 1
                        st = self._evacuating.pop(sid, None)
                        if st is not None:
                            self._host[sid] = st
                            self._host.move_to_end(sid)
                    self._m_lost["disk_error"].inc()
                    continue
                self._m_spill["disk"].inc()
                with self._lock:
                    self.spills["disk"] += 1
                    self._evacuating.pop(sid, None)
                    undo = sid in self._dropped
                if undo:
                    self._disk.discard(sid)
        finally:
            with self._lock:
                self._flushing -= 1
                if not self._flushing:
                    self._dropped.clear()

    def flush(self, timeout: float | None = None) -> bool:
        """Block until every queued and in-flight spill has landed (True)
        or ``timeout`` expired (False)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._work:
            while self._queue or self._in_flight:
                self._ensure_worker_locked()
                if deadline is None:
                    self._work.wait(timeout=1.0)
                else:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return False
                    self._work.wait(timeout=min(left, 1.0))
            return True

    # ---- fill (back into a device slot) -----------------------------------

    def has(self, sid: str) -> bool:
        """Does any tier hold restorable state for ``sid``?"""
        with self._lock:
            return self._has_memory_locked(sid) or (
                self._disk is not None and self._disk.has(sid))

    def _has_memory_locked(self, sid: str) -> bool:
        job = self._pending.get(sid)
        return ((job is not None and (job.to_host or job.to_disk))
                or sid in self._host or sid in self._evacuating)

    def resident_tier(self, sid: str) -> str | None:
        """'pending' | 'host' | 'disk' | None."""
        with self._lock:
            job = self._pending.get(sid)
            if job is not None and (job.to_host or job.to_disk):
                return "pending"
            if sid in self._host or sid in self._evacuating:
                return "host"
            if self._disk is not None and self._disk.has(sid):
                return "disk"
            return None

    def _take_memory_locked(self, sid: str):
        """The freshest in-memory copy of ``sid``, with its bookkeeping
        done: a pending :class:`Capture` (the disk leg of its job, if any,
        still runs: that file stays the valid checkpoint), a host
        :class:`DetachedState`, or None."""
        job = self._pending.get(sid)
        if job is not None and (job.to_host or job.to_disk):
            job.to_host = False
            if not job.to_disk and not job.in_queue:
                del self._pending[sid]
            self._host.pop(sid, None)
            return job.cap
        state = self._host.pop(sid, None)
        if state is None:
            state = self._evacuating.get(sid)  # its disk write stays valid
        return state

    def _write(self, slots: list[int], states: list) -> None:
        """One scatter of captures (device rows) or host states into
        ``slots``."""
        if isinstance(states[0], Capture):
            h = torch.stack([s.h for s in states], dim=1)
            c = torch.stack([s.c for s in states], dim=1)
        else:
            h = np.stack([s.h for s in states], axis=1)
            c = np.stack([s.c for s in states], axis=1)
        self.cache.write_slots(slots, h, c)

    def _count_fills(self, tier: str, n: int, seconds: float) -> None:
        with self._lock:
            self.fills[tier] += n
            if n:
                self.fill_seconds.add(seconds, n)

    def fill(self, sid: str, slot: int) -> bool:
        """Restore ``sid``'s spilled state into the (acquired and pinned)
        ``slot``: pending capture, host RAM, then disk (read and verified
        outside the lock). False when no tier holds usable state (a miss,
        or a corrupt file, quarantined and counted): the caller fails the
        continuation."""
        return self.fill_batch([(sid, slot)])[sid]

    def fill_batch(self, pairs) -> dict[str, bool]:
        """Batched :meth:`fill` over ``[(sid, slot), ...]`` with unique
        sids: one scatter per source class (pending captures, host states,
        disk states) instead of one per session. Returns ``{sid:
        filled}``. The tier bookkeeping takes one lock hold; disk reads run
        outside it, after the memory-sourced fills are written."""
        pairs = list(pairs)
        if not pairs:
            return {}
        t0 = time.perf_counter()
        results = {sid: False for sid, _ in pairs}
        dev, host, disk_cands = [], [], []
        misses = 0
        with self._lock:
            for sid, slot in pairs:
                got = self._take_memory_locked(sid)
                if isinstance(got, Capture):
                    dev.append((sid, slot, got))
                elif got is not None:
                    host.append((sid, slot, got))
                elif self._disk is not None:
                    disk_cands.append((sid, slot))
                else:
                    misses += 1
        for group in (dev, host):
            if group:
                self._write([slot for _, slot, _ in group],
                            [st for _, _, st in group])
        end_mem = time.perf_counter()
        disk = []
        for sid, slot in disk_cands:
            state = None
            try:
                state = self._disk.get(sid, self.cache.num_layers,
                                       self.cache.hidden_size)
            except CorruptCheckpointError as e:
                print(f"serve tiers: QUARANTINED corrupt session file "
                      f"for {sid!r}: {e}", flush=True)
                with self._lock:
                    self.corrupt += 1
                self._m_lost["corrupt"].inc()
            if state is None:
                misses += 1
            else:
                disk.append((sid, slot, state))
        if disk:
            self._write([slot for _, slot, _ in disk],
                        [st for _, _, st in disk])
        end_disk = time.perf_counter()
        self._count_fills("host", len(dev) + len(host), end_mem - t0)
        self._count_fills("disk", len(disk), end_disk - t0)
        with self._lock:
            self.fills_pending += len(dev)
            self.misses += misses
        n_host = len(dev) + len(host)
        if n_host:
            self._m_fill["host"].inc(n_host)
        if disk:
            self._m_fill["disk"].inc(len(disk))
        if misses:
            self._m_lost["miss"].inc(misses)
        for sid, _, _ in (*dev, *host):
            results[sid] = True
            self._m_fill_lat.observe(end_mem - t0)
        for sid, _, _ in disk:
            results[sid] = True
            self._m_fill_lat.observe(end_disk - t0)
        return results

    def fill_memory(self, sid: str, slot: int) -> bool:
        """Memory-tiers-only :meth:`fill` (no disk leg): safe with the
        shared lock held, which is how the prefix cache promotes a spilled
        entry (prefix states never reach the disk tier)."""
        t0 = time.perf_counter()
        with self._lock:
            got = self._take_memory_locked(sid)
            if got is None:
                self.misses += 1
                self._m_lost["miss"].inc()
                return False
            self._write([slot], [got])
            seconds = time.perf_counter() - t0
            self._count_fills("host", 1, seconds)
            self.fills_pending += isinstance(got, Capture)
        self._m_fill["host"].inc()
        self._m_fill_lat.observe(seconds)
        return True

    def discard_memory(self, sid: str) -> None:
        """Memory-tiers-only :meth:`discard` (no file IO: safe under the
        shared lock)."""
        with self._lock:
            job = self._pending.get(sid)
            if job is not None:
                job.to_host = job.to_disk = False
                if not job.in_queue:
                    del self._pending[sid]
            self._host.pop(sid, None)
            self._evacuating.pop(sid, None)

    def discard(self, sid: str) -> None:
        """Drop every tier's copy of ``sid`` (an un-kept completion: a
        stale copy must not resurrect the conversation)."""
        with self._lock:
            self.discard_memory(sid)
            if self._flushing:
                self._dropped.add(sid)  # a write for it may be mid-flight
        if self._disk is not None:
            self._disk.discard(sid)

    def warmup_fills(self, max_batch: int) -> None:
        """Run the fill path's scatters (host rows and device captures)
        against the scratch slot at every power-of-two batch up to
        ``max_batch``, so the first continuation burst pays no first-launch
        cost. The scratch slot is harmless by definition."""
        L, H = self.cache.num_layers, self.cache.hidden_size
        scratch = self.cache.scratch_slot
        n = 1
        while True:
            z = np.zeros((L, H), np.float32)
            self._write([scratch] * n, [DetachedState(z, z)] * n)
            self._write([scratch] * n, [self.cache.capture(scratch)] * n)
            if n >= max(1, max_batch):
                break
            n *= 2

    def stats(self) -> dict:
        with self._lock:
            return {
                "host_entries_max": self.host_entries,
                "entries": {
                    "pending": sum(1 for j in self._pending.values()
                                   if j.to_host or j.to_disk),
                    "host": len(self._host) + len(self._evacuating),
                    "disk": 0 if self._disk is None else len(self._disk),
                },
                "disk_dir": None if self._disk is None
                else self._disk.directory,
                "spills": dict(self.spills),
                "fills": dict(self.fills),
                "fills_pending": self.fills_pending,
                "misses": self.misses,
                "corrupt": self.corrupt,
                "lost": self.lost,
                "disk_errors": self.disk_errors,
                "spill_seconds": self.spill_seconds.summary(),
                "fill_seconds": self.fill_seconds.summary(),
            }
