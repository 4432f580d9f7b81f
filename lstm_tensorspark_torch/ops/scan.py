"""Sequence unrolling of the LSTM cell: a Python loop over time.

Port of the forward of ``lstm_tensorspark_tpu/ops/scan.py`` as serving
runs it: deterministic (no dropout), no rematerialisation, no kernel
dispatch. The input projection for all T steps is one matmul hoisted out
of the loop; a boolean ``mask`` freezes the carry at padded steps, so a
right-padded batch ends with each row's state at its true end.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .lstm_cell import LSTMParams, fuse_params, lstm_step_hoisted, zero_carry


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


def stacked_lstm_scan(layer_params: Sequence[LSTMParams], xs: torch.Tensor,
                      carries=None, *, mask: torch.Tensor | None = None,
                      reverse: bool = False):
    """Stack layers over the same time axis. Returns (per-layer final
    carries, top-layer outputs [B, T, H])."""
    ys = xs
    finals = []
    for idx, p in enumerate(layer_params):
        c0 = None if carries is None else carries[idx]
        final, ys = lstm_scan(p, ys, c0, mask=mask, reverse=reverse)
        finals.append(final)
    return finals, ys
