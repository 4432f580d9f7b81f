"""Both directions of one bi-LSTM layer in one launch of the residentx pair.

Counterpart of ``lstm_tensorspark_tpu/ops/pallas_bilstm.py``. The reverse
direction is a forward-in-time scan over time-flipped inputs and mask (the
flips sit outside the autograd Function, so autograd transposes them), so
the two directions are the same computation with different weights. Rows
are stacked — 0:B the forward direction, B:2B the reverse — and the
weights carry a leading direction axis; ``csrc/lstmx_fwd.cu`` and
``csrc/lstmx_bwd.cu`` run the two directions' clusters side by side in one
launch each, halving the dependent steps a layer waits for. Zero initial
carries, the bi-LSTM layer contract (the classifier never seeds carries).

:func:`bilstm_supported` is the dispatch gate (``pallas_bilstm.
bilstm_supported``): the sequence is long enough for the residentx class
(T >= ``FUSEDX_MIN_T``), the stacked plan fits a block and the cs residual
fits its budget. Everything else runs as two single-direction scans at the
dispatch layer (``ops/scan.bidir_lstm_scan``).
"""

from __future__ import annotations

import torch

from .cuda_lstmx import (FUSEDX_MIN_T, RESIDUAL_BUDGET_BYTES, fits,
                         lstmx_recurrence)
from .lstm_cell import LSTMParams, fuse_params


def bilstm_supported(batch: int, hidden: int, d_in: int, seq_len: int,
                     num_sms: int = 132) -> bool:
    """Can the stacked-direction pair run this layer (``batch`` rows per
    direction)?"""
    return (hidden >= 1 and seq_len >= FUSEDX_MIN_T
            and fits(batch, hidden, d_in, 2, num_sms)
            and seq_len * 2 * batch * hidden * 4 <= RESIDUAL_BUDGET_BYTES)


def cuda_bilstm_scan(params_fwd: LSTMParams, params_bwd: LSTMParams,
                     xs: torch.Tensor, *, mask: torch.Tensor | None = None):
    """Both directions of one layer over ``xs`` [B, T, D] (``mask`` bool
    [B, T] or None): equivalent to ``lstm_scan(params_fwd, xs, mask=mask)``
    and ``lstm_scan(params_bwd, xs, mask=mask, reverse=True)`` — the
    reverse rows walk a right-padded tail first with a frozen zero carry.
    Returns ``(((hT_f, cT_f), ys_f), ((hT_b, cT_b), ys_b))``."""
    B, T, _ = xs.shape
    H = params_fwd.hidden_size
    if params_bwd.hidden_size != H:
        raise ValueError("direction hidden sizes differ")
    ff, fb = fuse_params(params_fwd), fuse_params(params_bwd)
    xs2 = torch.cat([xs, torch.flip(xs, dims=(1,))], dim=0)
    m = None
    if mask is not None:
        m2 = torch.cat([mask, torch.flip(mask, dims=(1,))], dim=0)
        m = m2.transpose(0, 1).to(torch.float32).contiguous()
    h0 = torch.zeros((2 * B, H), dtype=torch.float32, device=xs.device)
    ys2, hT, cT = lstmx_recurrence(
        xs2.transpose(0, 1).contiguous(),
        torch.stack([ff.kernel, fb.kernel]), torch.stack([ff.bias, fb.bias]),
        torch.stack([ff.recurrent, fb.recurrent]), h0, torch.zeros_like(h0),
        m)
    ys_f = ys2[:, :B].transpose(0, 1)
    ys_b = torch.flip(ys2[:, B:].transpose(0, 1), dims=(1,))
    return ((hT[:B], cT[:B]), ys_f), ((hT[B:], cT[B:]), ys_b)
