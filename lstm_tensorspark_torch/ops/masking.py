"""Variable-length masks and inverted dropout.

Port of ``lstm_tensorspark_tpu/ops/masking.py``. JAX draws dropout from a
threefry key; here it comes from a ``torch.Generator``. The two give other
bits from the same seed, so dropout is held against the JAX package by its
keep mask: :func:`dropout_with_keep` applies a given mask, and the tests
feed it JAX's.
"""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """Bool mask [B, maxlen]: True where position < length."""
    pos = torch.arange(maxlen, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def dropout_keep(gen: torch.Generator, rate: float, shape,
                 device) -> torch.Tensor:
    """A keep mask: each entry True with probability ``1 - rate``, drawn
    from ``gen`` (a generator on ``device``)."""
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def dropout_with_keep(keep: torch.Tensor, rate: float,
                      x: torch.Tensor) -> torch.Tensor:
    """Inverted dropout with a given keep mask: kept entries scaled by
    ``1 / (1 - rate)`` (an IEEE division, as JAX's), the rest 0; identity at
    rate 0."""
    if rate <= 0.0:
        return x
    scale = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros_like(x))


def dropout(gen: torch.Generator, rate: float, x: torch.Tensor) -> torch.Tensor:
    """Inverted dropout with a fresh keep mask from ``gen``; identity at
    rate 0."""
    if rate <= 0.0:
        return x
    return dropout_with_keep(dropout_keep(gen, rate, x.shape, x.device), rate,
                             x)
