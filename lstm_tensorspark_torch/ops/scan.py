"""Sequence unrolling of the LSTM cell, and the kernel dispatch.

Port of ``lstm_tensorspark_tpu/ops/scan.py``:

- :func:`lstm_scan` is the plain version: a Python loop over time, the
  input projection hoisted into one matmul, a boolean ``mask`` freezing the
  carry at padded steps (so a right-padded batch ends with each row's state
  at its true end), ``reverse`` scanning right to left, and ``remat_chunk``
  checkpointing chunks of that many steps (``torch.utils.checkpoint``:
  only the chunk boundaries' carries are kept, each chunk's forward is
  recomputed in the backward). Plain torch ops, so autograd flows through.
- :func:`auto_lstm_scan` is the dispatch point (JAX ``auto_lstm_scan``):
  CPU tensors run :func:`lstm_scan`; CUDA tensors run the hand-written
  kernels along the JAX package's strategy lattice, which
  :func:`chosen_bwd_strategy` / :func:`chosen_fwd_strategy` mirror:
  ``bptt="assoc"`` raises; with ``remat_chunk`` the forward kernel runs
  and the backward is the plain recompute; at T >= ``FUSEDX_MIN_T`` the
  residentx pair (``ops/cuda_lstmx.py``) when its plan fits; otherwise the
  resident pair (``ops/cuda_lstm.py``) when its blocks keep their slice of
  U on chip, else the tiled pair (``ops/cuda_lstm_tiled.py``)
  when its plan fits, else the resident pair reading U through L2; no plan
  raises.
- :func:`bidir_lstm_scan` runs both directions of a bi-LSTM layer: the
  stacked-direction pair (``ops/cuda_bilstm.py``) when it applies, else
  two :func:`auto_lstm_scan` calls.
- :func:`stacked_lstm_scan` runs layers one after another through the
  dispatch, with inter-layer dropout.

The parallel-scan backward (``bptt="assoc"``) is not ported and raises.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from . import cuda_lstm, cuda_lstm_tiled, cuda_lstmx
from .cuda_bilstm import bilstm_supported, cuda_bilstm_scan
from .cuda_lstm import cuda_lstm_scan
from .cuda_lstm_tiled import cuda_lstm_tiled_scan
from .cuda_lstmx import cuda_lstmx_scan
from .lstm_cell import LSTMParams, fuse_params, lstm_step_hoisted, zero_carry
from .masking import dropout, dropout_with_keep

BPTT_MODES = ("sequential", "auto", "assoc")


def _steps(fused, carry, zx, mask, reverse):
    """The recurrence over pre-projected ``zx`` [B, t, 4H]; returns (final
    carry, ys [B, t, H])."""
    n = zx.shape[1]
    ys = [None] * n
    for t in (range(n - 1, -1, -1) if reverse else range(n)):
        (h_new, c_new), _ = lstm_step_hoisted(fused, carry, zx[:, t])
        if mask is not None:
            m = mask[:, t, None]
            h_new = torch.where(m, h_new, carry[0])
            c_new = torch.where(m, c_new, carry[1])
        carry = (h_new, c_new)
        ys[t] = h_new
    return carry, torch.stack(ys, dim=1)


def _check_remat(T: int, remat_chunk: int | None) -> None:
    if remat_chunk is not None and T % remat_chunk != 0:
        raise ValueError(
            f"T={T} not divisible by remat_chunk={remat_chunk} — a "
            "tail chunk would silently change remat (and bptt-mode) "
            "semantics; pad or pick a divisor")


def lstm_scan(params: LSTMParams, xs: torch.Tensor, carry=None, *,
              mask: torch.Tensor | None = None, reverse: bool = False,
              remat_chunk: int | None = None):
    """Run one LSTM layer over ``xs`` [B, T, D].

    ``carry``: optional initial ``(h, c)`` each [B, H] (zeros if None);
    ``mask``: optional bool [B, T], False steps leave the carry unchanged;
    ``reverse``: scan right to left; ``remat_chunk``: checkpoint chunks of
    that many steps (T must be divisible by it), projecting each chunk's
    inputs inside its checkpoint as the JAX scan does. Returns ``((h_T,
    c_T), ys)`` with ``ys`` [B, T, H] (the carried h at every step).
    """
    B, T, _ = xs.shape
    _check_remat(T, remat_chunk)
    fused = fuse_params(params)
    if carry is None:
        carry = zero_carry(B, params.hidden_size, device=xs.device)
    if remat_chunk is None:
        zx = xs @ fused.kernel + fused.bias  # [B, T, 4H], one matmul
        return _steps(fused, carry, zx, mask, reverse)

    def chunk(kernel, recurrent, bias, h, c, x, m):
        f = fused._replace(kernel=kernel, recurrent=recurrent, bias=bias)
        return _steps(f, (h, c), x @ kernel + bias, m, reverse)

    starts = range(0, T, remat_chunk)
    ys = [None] * len(starts)
    for i in (reversed(range(len(starts))) if reverse else range(len(starts))):
        sl = slice(starts[i], starts[i] + remat_chunk)
        m = None if mask is None else mask[:, sl]
        carry, ys[i] = checkpoint(chunk, fused.kernel, fused.recurrent,
                                  fused.bias, carry[0], carry[1], xs[:, sl],
                                  m, use_reentrant=False)
    return carry, torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# the strategy lattice
# ---------------------------------------------------------------------------


def chosen_fwd_strategy(B: int, T: int, H: int, D: int, *,
                        num_sms: int = 132) -> str:
    """The forward kernel a CUDA scan runs, in the JAX package's order:
    ``"residentx"`` at T >= ``FUSEDX_MIN_T`` when its plan fits; then
    ``"resident"`` when its blocks keep their slice of U on chip (shared
    memory or registers);
    then ``"tiled"`` when the tiled pair's plan fits; then ``"resident"``
    reading U through L2. The test is Hopper's shared memory, not the TPU's
    VMEM budget. Raises ``ValueError`` when nothing fits."""
    if T >= cuda_lstmx.FUSEDX_MIN_T and cuda_lstmx.fits(B, H, D, 1, num_sms):
        return "residentx"
    try:
        p = cuda_lstm.plan("fwd", B, H, num_sms)
        keeps_u = p.smem_w or p.u_regs
    except ValueError:
        keeps_u = False
    if not keeps_u and cuda_lstm_tiled.fits(B, H, num_sms):
        return "tiled"
    cuda_lstm.plan("fwd", B, H, num_sms)  # raises when it does not fit
    return "resident"


def chosen_bwd_strategy(B: int, T: int, H: int, D: int, *,
                        remat_chunk: int | None = None,
                        num_sms: int = 132) -> str:
    """The gradient path a CUDA scan takes (JAX ``chosen_bwd_strategy``):
    ``"recompute"`` when ``remat_chunk`` is set or the residuals exceed
    their budget, else the backward kernel paired with
    :func:`chosen_fwd_strategy`'s forward — ``"residentx"``,
    ``"resident"`` or ``"tiled"``. Raises ``ValueError`` when no plan
    fits."""
    fwd = chosen_fwd_strategy(B, T, H, D, num_sms=num_sms)
    if remat_chunk is not None:
        return "recompute"
    if fwd == "resident":
        cuda_lstm.plan("bwd", B, H, num_sms)  # raises when it does not fit
    per_step = 4 if fwd == "residentx" else 4 * 4 + 4  # cs; z and cs
    if T * B * H * per_step > cuda_lstmx.RESIDUAL_BUDGET_BYTES:
        return "recompute"
    return fwd


# the layer scan of each kernel route
_SCANS = {"residentx": cuda_lstmx_scan, "resident": cuda_lstm_scan,
          "tiled": cuda_lstm_tiled_scan}


class _KernelForwardRecompute(torch.autograd.Function):
    """The forward kernel's values with the plain recompute backward (JAX
    ``_scan_core_bwd``'s recompute branch): the backward re-runs
    :func:`lstm_scan` with ``remat_chunk`` under autograd and pulls the
    cotangents through it."""

    @staticmethod
    def forward(ctx, spec, xs, h0, c0, *gates):
        fwd, mask, remat_chunk = spec
        scan = _SCANS[fwd]
        (hT, cT), ys = scan(LSTMParams(*gates), xs, (h0, c0), mask=mask)
        ctx.spec = spec
        ctx.save_for_backward(xs, h0, c0, *gates)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        _, mask, remat_chunk = ctx.spec
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            xs, h0, c0, *gates = leaves
            (hT, cT), ys = lstm_scan(LSTMParams(*gates), xs, (h0, c0),
                                     mask=mask, remat_chunk=remat_chunk)
            grads = torch.autograd.grad((ys, hT, cT), leaves, (dys, dhT, dcT))
        return (None, *grads)


def kernel_lstm_scan(params: LSTMParams, xs: torch.Tensor, carry=None, *,
                     mask: torch.Tensor | None = None, reverse: bool = False,
                     remat_chunk: int | None = None):
    """:func:`lstm_scan`'s contract through the kernels that
    :func:`chosen_bwd_strategy` picks (on CPU tensors their plain
    versions run, which is how the tests reach each route)."""
    B, T, D = xs.shape
    H = params.hidden_size
    num_sms = (cuda_lstm._num_sms(xs.device) if xs.device.type == "cuda"
               else 132)
    _check_remat(T, remat_chunk)
    bwd = chosen_bwd_strategy(B, T, H, D, remat_chunk=remat_chunk,
                              num_sms=num_sms)
    if bwd in _SCANS:
        return _SCANS[bwd](params, xs, carry, mask=mask, reverse=reverse)
    fwd = chosen_fwd_strategy(B, T, H, D, num_sms=num_sms)
    if reverse:
        xs = torch.flip(xs, dims=(1,))
        if mask is not None:
            mask = torch.flip(mask, dims=(1,))
    if carry is None:
        carry = zero_carry(B, H, device=xs.device)
    ys, hT, cT = _KernelForwardRecompute.apply(
        (fwd, mask, remat_chunk), xs, carry[0], carry[1], *params)
    if reverse:
        ys = torch.flip(ys, dims=(1,))
    return (hT, cT), ys


def _check_bptt(bptt: str) -> None:
    if bptt not in BPTT_MODES:
        raise ValueError(f"bptt must be one of {BPTT_MODES}, got {bptt!r}")
    if bptt == "assoc":
        raise NotImplementedError(
            "bptt='assoc' (the parallel-scan backward) is not ported yet")


def auto_lstm_scan(params: LSTMParams, xs: torch.Tensor, carry=None, *,
                   mask: torch.Tensor | None = None, reverse: bool = False,
                   remat_chunk: int | None = None, bptt: str = "sequential"):
    """:func:`lstm_scan`'s contract, through the kernels for CUDA tensors
    (:func:`kernel_lstm_scan`) and the plain loop for CPU tensors.
    ``bptt="auto"`` is the sequential backward (the parallel-scan backward
    it could pick is not ported); an explicit ``"assoc"`` raises."""
    _check_bptt(bptt)
    if xs.device.type == "cuda":
        return kernel_lstm_scan(params, xs, carry, mask=mask, reverse=reverse,
                                remat_chunk=remat_chunk)
    return lstm_scan(params, xs, carry, mask=mask, reverse=reverse,
                     remat_chunk=remat_chunk)


def bidir_route(B: int, T: int, H_fwd: int, H_bwd: int, D: int, *,
                remat_chunk: int | None = None, bptt: str = "sequential",
                num_sms: int = 132) -> str:
    """How a CUDA bi-LSTM layer runs (JAX ``bidir_lstm_scan``'s gate):
    ``"stacked"`` — one launch of the stacked pair — when there is no
    ``remat_chunk``, no explicit assoc BPTT and :func:`bilstm_supported`;
    else ``"two_scans"``."""
    if (remat_chunk is None and bptt != "assoc" and H_fwd == H_bwd
            and bilstm_supported(B, H_fwd, D, T, num_sms)):
        return "stacked"
    return "two_scans"


def bidir_lstm_scan(params_fwd: LSTMParams, params_bwd: LSTMParams,
                    xs: torch.Tensor, *, mask: torch.Tensor | None = None,
                    remat_chunk: int | None = None, bptt: str = "sequential"):
    """Both directions of one bi-LSTM layer over ``xs`` [B, T, D], zero
    initial carries. Returns ``(((hT_f, cT_f), ys_f), ((hT_b, cT_b),
    ys_b))``."""
    B, T, D = xs.shape
    if xs.device.type == "cuda" and bidir_route(
            B, T, params_fwd.hidden_size, params_bwd.hidden_size, D,
            remat_chunk=remat_chunk, bptt=bptt,
            num_sms=cuda_lstm._num_sms(xs.device)) == "stacked":
        return cuda_bilstm_scan(params_fwd, params_bwd, xs, mask=mask)
    out_f = auto_lstm_scan(params_fwd, xs, mask=mask, remat_chunk=remat_chunk,
                           bptt=bptt)
    out_b = auto_lstm_scan(params_bwd, xs, mask=mask, reverse=True,
                           remat_chunk=remat_chunk, bptt=bptt)
    return out_f, out_b


def stacked_lstm_scan(layer_params: Sequence[LSTMParams], xs: torch.Tensor,
                      carries=None, *, mask: torch.Tensor | None = None,
                      reverse: bool = False, remat_chunk: int | None = None,
                      bptt: str = "sequential", dropout_rate: float = 0.0,
                      dropout_gen: torch.Generator | None = None,
                      dropout_keeps: Iterator[torch.Tensor] | None = None):
    """Stack layers over the same time axis, each through
    :func:`auto_lstm_scan`. With ``dropout_rate`` > 0 and a source of keep
    masks — drawn from ``dropout_gen``, or taken in order from
    ``dropout_keeps`` (the tests feed JAX's) — inverted dropout is applied
    to the full [B, T, H] output between layers, never after the top layer
    (JAX ``stacked_lstm_scan``; no source is its ``deterministic``).
    Returns (per-layer final carries, top-layer outputs [B, T, H])."""
    ys = xs
    finals = []
    n = len(layer_params)
    for idx, p in enumerate(layer_params):
        c0 = None if carries is None else carries[idx]
        final, ys = auto_lstm_scan(p, ys, c0, mask=mask, reverse=reverse,
                                   remat_chunk=remat_chunk, bptt=bptt)
        finals.append(final)
        if idx < n - 1 and dropout_rate > 0.0:
            if dropout_keeps is not None:
                ys = dropout_with_keep(next(dropout_keeps), dropout_rate, ys)
            elif dropout_gen is not None:
                ys = dropout(dropout_gen, dropout_rate, ys)
    return finals, ys
