"""Sequence unrolling of the LSTM cell, and the kernel dispatch.

Port of ``lstm_tensorspark_tpu/ops/scan.py``:

- :func:`lstm_scan` is the plain version: a Python loop over time, the
  input projection for all T steps hoisted into one matmul, a boolean
  ``mask`` freezing the carry at padded steps (so a right-padded batch ends
  with each row's state at its true end), ``reverse`` scanning right to
  left. Plain torch ops, so autograd flows through it.
- :func:`auto_lstm_scan` is the dispatch point (JAX ``auto_lstm_scan``):
  CUDA tensors go through the hand-written recurrence kernels
  (``ops/cuda_lstm.cuda_lstm_scan``, forward and fused backward), CPU
  tensors through :func:`lstm_scan`. There is no switch: on the card the
  kernels are the recurrence.
- :func:`stacked_lstm_scan` runs layers one after another through the
  dispatch.

No dropout and no rematerialisation yet; the parallel-scan backward
(``bptt="assoc"``) is not ported and raises.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .cuda_lstm import cuda_lstm_scan
from .lstm_cell import LSTMParams, fuse_params, lstm_step_hoisted, zero_carry

BPTT_MODES = ("sequential", "auto", "assoc")


def lstm_scan(params: LSTMParams, xs: torch.Tensor, carry=None, *,
              mask: torch.Tensor | None = None, reverse: bool = False):
    """Run one LSTM layer over ``xs`` [B, T, D].

    ``carry``: optional initial ``(h, c)`` each [B, H] (zeros if None);
    ``mask``: optional bool [B, T], False steps leave the carry unchanged;
    ``reverse``: scan right to left. Returns ``((h_T, c_T), ys)`` with
    ``ys`` [B, T, H] (the carried h at every step).
    """
    B, T, _ = xs.shape
    fused = fuse_params(params)
    if carry is None:
        carry = zero_carry(B, params.hidden_size, device=xs.device)
    zx = xs @ fused.kernel + fused.bias  # [B, T, 4H], one matmul
    ys = [None] * T
    steps = range(T - 1, -1, -1) if reverse else range(T)
    for t in steps:
        (h_new, c_new), _ = lstm_step_hoisted(fused, carry, zx[:, t])
        if mask is not None:
            m = mask[:, t, None]
            h_new = torch.where(m, h_new, carry[0])
            c_new = torch.where(m, c_new, carry[1])
        carry = (h_new, c_new)
        ys[t] = h_new
    return carry, torch.stack(ys, dim=1)


def auto_lstm_scan(params: LSTMParams, xs: torch.Tensor, carry=None, *,
                   mask: torch.Tensor | None = None, reverse: bool = False,
                   bptt: str = "sequential"):
    """:func:`lstm_scan`'s contract, through the recurrence kernels for
    CUDA tensors and the plain loop for CPU tensors. ``bptt="auto"`` is the
    sequential backward (the parallel-scan backward it could pick is not
    ported); an explicit ``"assoc"`` raises."""
    if bptt not in BPTT_MODES:
        raise ValueError(f"bptt must be one of {BPTT_MODES}, got {bptt!r}")
    if bptt == "assoc":
        raise NotImplementedError(
            "bptt='assoc' (the parallel-scan backward) is not ported yet")
    if xs.device.type == "cuda":
        return cuda_lstm_scan(params, xs, carry, mask=mask, reverse=reverse)
    return lstm_scan(params, xs, carry, mask=mask, reverse=reverse)


def stacked_lstm_scan(layer_params: Sequence[LSTMParams], xs: torch.Tensor,
                      carries=None, *, mask: torch.Tensor | None = None,
                      reverse: bool = False, bptt: str = "sequential"):
    """Stack layers over the same time axis, each through
    :func:`auto_lstm_scan`. Returns (per-layer final carries, top-layer
    outputs [B, T, H])."""
    ys = xs
    finals = []
    for idx, p in enumerate(layer_params):
        c0 = None if carries is None else carries[idx]
        final, ys = auto_lstm_scan(p, ys, c0, mask=mask, reverse=reverse,
                                   bptt=bptt)
        finals.append(final)
    return finals, ys
