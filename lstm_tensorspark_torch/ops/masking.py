"""Variable-length masks and inverted dropout.

Port of ``lstm_tensorspark_tpu/ops/masking.py``. JAX draws dropout from a
threefry key; here it comes from a ``torch.Generator``. The two give other
bits from the same seed, so dropout is held against the JAX package by its
keep mask: :func:`dropout_with_keep` applies a given mask, and the tests
feed it JAX's.

:func:`track_generators` records the generators :func:`dropout_keep`
draws from, each with its state before its first draw: a CUDA graph of a
train step (``train/graphs.py``) registers them, so that its replays draw
new masks, and restores them after its warm-up.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_tracking = threading.local()


@contextlib.contextmanager
def track_generators():
    """Inside the block, record each generator :func:`dropout_keep` draws
    from in this thread: yields {generator: its state before its first
    draw}."""
    prev = getattr(_tracking, "seen", None)
    _tracking.seen = seen = {}
    try:
        yield seen
    finally:
        _tracking.seen = prev


def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """Bool mask [B, maxlen]: True where position < length."""
    pos = torch.arange(maxlen, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def dropout_keep(gen: torch.Generator, rate: float, shape,
                 device) -> torch.Tensor:
    """A keep mask: each entry True with probability ``1 - rate``, drawn
    from ``gen`` (a generator on ``device``)."""
    seen = getattr(_tracking, "seen", None)
    if seen is not None and gen not in seen:
        seen[gen] = gen.get_state()
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def dropout_with_keep(keep: torch.Tensor, rate: float,
                      x: torch.Tensor) -> torch.Tensor:
    """Inverted dropout with a given keep mask: kept entries scaled by
    ``1 / (1 - rate)`` (an IEEE division, as JAX's), the rest 0; identity at
    rate 0."""
    if rate <= 0.0:
        return x
    # a fill on the device, not a copy from the host: a CUDA graph can
    # capture it
    scale = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros_like(x))


def dropout(gen: torch.Generator, rate: float, x: torch.Tensor) -> torch.Tensor:
    """Inverted dropout with a fresh keep mask from ``gen``; identity at
    rate 0."""
    if rate <= 0.0:
        return x
    return dropout_with_keep(dropout_keep(gen, rate, x.shape, x.device), rate,
                             x)
