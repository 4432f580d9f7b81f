"""Slot-based device-resident cache of per-session recurrent state.

Port of ``StateCache`` and ``CacheFullError`` from
``lstm_tensorspark_tpu/serve/state_cache.py``. An LSTM session's whole
decode state is ``(h, c)`` per layer, fixed-size whatever the session has
consumed. The cache holds it as two device tensors ``[L, S+1, H]`` float32
plus a host-side session table:

- sessions map to integer **slots**; the engine gathers carries by slot
  (``index_select``), runs the step and scatters the results back
  (``index_copy_``) — in place, in stream order, where the JAX package
  threads immutable arrays through its programs;
- slot ``S`` (the last row) is a **scratch slot**: batches padded up to a
  bucket point their dead rows at it, so padding never touches a live
  session;
- **LRU eviction** frees the least-recently-used unpinned slot when the
  cache is full; the batcher pins the slots of active sessions.

``generation`` counts device updates applied to the cache, so
``tokens_generated / generation`` shows the effective window size.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch


class CacheFullError(RuntimeError):
    """No free slot and every occupied slot is pinned."""


class StateCache:
    def __init__(self, num_layers: int, num_slots: int, hidden_size: int,
                 device: torch.device):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_layers = num_layers
        self.num_slots = num_slots
        self.hidden_size = hidden_size
        # +1: the scratch slot for padded batch rows (index == num_slots)
        shape = (num_layers, num_slots + 1, hidden_size)
        self.h = torch.zeros(shape, dtype=torch.float32, device=device)
        self.c = torch.zeros(shape, dtype=torch.float32, device=device)
        self._lock = threading.RLock()
        self._slots: OrderedDict[str, int] = OrderedDict()  # LRU: oldest first
        self._free: list[int] = list(range(num_slots))
        self._pinned: set[str] = set()
        self.evictions = 0
        self.generation = 0  # device updates applied to h/c

    @property
    def scratch_slot(self) -> int:
        return self.num_slots

    # ---- session table -------------------------------------------------

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
                return slot
        raise CacheFullError(f"all {self.num_slots} slots pinned by active "
                             "sessions")

    def release(self, session_id: str) -> None:
        """Drop the session; its slot returns to the free list. No-op for
        unknown sessions."""
        with self._lock:
            self._pinned.discard(session_id)
            slot = self._slots.pop(session_id, None)
            if slot is not None:
                self._free.append(slot)

    # ---- device state --------------------------------------------------

    def read_slots(self, slots: torch.Tensor):
        """Gather carries for ``slots`` [B] (an int64 device tensor) →
        ``(h, c)`` each [L, B, H]."""
        return self.h.index_select(1, slots), self.c.index_select(1, slots)

    def write_slots(self, slots: torch.Tensor, h: torch.Tensor,
                    c: torch.Tensor) -> None:
        """Scatter ``(h, c)`` each [L, B, H] into ``slots`` [B], in place.
        Padding rows all point at the scratch slot, so the only duplicate
        indices a batch carries are scratch rows, whose contents nothing
        reads — which duplicate lands there does not matter."""
        self.h.index_copy_(1, slots, h)
        self.c.index_copy_(1, slots, c)
        with self._lock:
            self.generation += 1

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
