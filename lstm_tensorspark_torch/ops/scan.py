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

``compute_dtype`` (None / float32, or bfloat16) follows JAX's: the plain
loop casts the fused matrices and rounds x and h only at the products
(its zx stays float32, with and without remat); the kernel routes store
their [T, B, 4H] streams (xproj, z, dz) in bfloat16, as JAX's Pallas
route does (the residentx pair keeps its projection in float32, as JAX's
does, and stores dz in bfloat16). Every route has its bfloat16 form.
``plain_rounding`` (forward only: JAX's serve prefill, which runs the
plain XLA scan) keeps the resident and tiled routes' projection float32,
as the plain loop and the residentx pair keep it.

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
from .lstm_cell import (LSTMParams, fuse_params, lstm_step_hoisted, mm_f32,
                        resolve_dtype, zero_carry)
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
              remat_chunk: int | None = None, compute_dtype=None):
    """Run one LSTM layer over ``xs`` [B, T, D].

    ``carry``: optional initial ``(h, c)`` each [B, H] (zeros if None);
    ``mask``: optional bool [B, T], False steps leave the carry unchanged;
    ``reverse``: scan right to left; ``remat_chunk``: checkpoint chunks of
    that many steps (T must be divisible by it), projecting each chunk's
    inputs inside its checkpoint as the JAX scan does; ``compute_dtype``:
    e.g. ``torch.bfloat16`` for the products (the projection zx, the cell
    state and the accumulation stay float32). Returns ``((h_T, c_T),
    ys)`` with ``ys`` [B, T, H] (the carried h at every step).
    """
    B, T, _ = xs.shape
    _check_remat(T, remat_chunk)
    cd = resolve_dtype(compute_dtype)
    fused = fuse_params(params, compute_dtype=cd)
    if carry is None:
        carry = zero_carry(B, params.hidden_size, device=xs.device)
    if remat_chunk is None:
        # [B, T, 4H], one matmul
        zx = mm_f32(xs.to(cd), fused.kernel) + fused.bias
        return _steps(fused, carry, zx, mask, reverse)

    def chunk(kernel, recurrent, bias, h, c, x, m):
        # a view a chunk: the chunk's steps sum their U cotangents first,
        # then the chunks add theirs (JAX's scan of checkpointed chunks;
        # the order shows in a bfloat16 cotangent)
        f = fused._replace(kernel=kernel, recurrent=recurrent.view_as(recurrent),
                           bias=bias)
        return _steps(f, (h, c), mm_f32(x.to(cd), kernel) + bias, m, reverse)

    starts = range(0, T, remat_chunk)
    ys = [None] * len(starts)
    for i in (reversed(range(len(starts))) if reverse else range(len(starts))):
        sl = slice(starts[i], starts[i] + remat_chunk)
        m = None if mask is None else mask[:, sl]
        carry, ys[i] = checkpoint(chunk, fused.kernel, fused.recurrent,
                                  fused.bias, carry[0], carry[1], xs[:, sl],
                                  m, use_reentrant=False,
                                  # the chunk draws no random numbers; and
                                  # the RNG state cannot be read or set
                                  # while a CUDA graph is being captured
                                  preserve_rng_state=False)
    return carry, torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# the strategy lattice
# ---------------------------------------------------------------------------


def chosen_fwd_strategy(B: int, T: int, H: int, D: int, *,
                        num_sms: int = 132, dev=None, esize: int = 4) -> str:
    """The forward kernel a CUDA scan runs, in the JAX package's order:
    ``"residentx"`` at T >= ``FUSEDX_MIN_T`` when its plan fits; then
    ``"resident"`` when its blocks keep their slice of U on chip (shared
    memory or registers);
    then ``"tiled"`` when the tiled pair's plan fits; then ``"resident"``
    reading U through L2. The test is Hopper's shared memory, not the TPU's
    VMEM budget; the tiled pair's, on the card ``dev`` when it is given
    (the plan its launch runs). ``esize`` is the bytes of an element of U
    and of the streams, as JAX's planners take ``pbytes``: 2 under
    bfloat16 compute. Raises ``ValueError`` when nothing fits."""
    if T >= cuda_lstmx.FUSEDX_MIN_T and cuda_lstmx.fits(B, H, D, 1, num_sms,
                                                        esize):
        return "residentx"
    try:
        p = cuda_lstm.plan("fwd", B, H, num_sms, esize=esize)
        keeps_u = p.smem_w or p.u_regs
    except ValueError:
        keeps_u = False
    if not keeps_u and cuda_lstm_tiled.fits(B, H, num_sms, dev, esize=esize):
        return "tiled"
    cuda_lstm.plan("fwd", B, H, num_sms, esize=esize)  # raises when no fit
    return "resident"


def chosen_bwd_strategy(B: int, T: int, H: int, D: int, *,
                        remat_chunk: int | None = None,
                        num_sms: int = 132, dev=None, esize: int = 4) -> str:
    """The gradient path a CUDA scan takes (JAX ``chosen_bwd_strategy``):
    ``"recompute"`` when ``remat_chunk`` is set or the residuals exceed
    their budget (z counted at ``esize`` bytes, cs at 4), else the
    backward kernel paired with :func:`chosen_fwd_strategy`'s forward —
    ``"residentx"``, ``"resident"`` or ``"tiled"``. Raises ``ValueError``
    when no plan fits."""
    fwd = chosen_fwd_strategy(B, T, H, D, num_sms=num_sms, dev=dev,
                              esize=esize)
    if remat_chunk is not None:
        return "recompute"
    if fwd == "resident":
        # raises when it does not fit
        cuda_lstm.plan("bwd", B, H, num_sms, esize=esize)
    per_step = 4 if fwd == "residentx" else 4 * esize + 4  # cs; z and cs
    if T * B * H * per_step > cuda_lstmx.RESIDUAL_BUDGET_BYTES:
        return "recompute"
    return fwd


def _route_scan(route: str, params, xs, carry, mask, reverse, cd,
                plain_rounding: bool = False):
    """The layer scan of kernel route ``route`` in compute dtype ``cd``
    (``plain_rounding``: the resident and tiled routes' forward-only form
    with a float32 projection; the residentx pair keeps its projection
    float32 in every form)."""
    if route == "residentx":
        return cuda_lstmx_scan(params, xs, carry, mask=mask, reverse=reverse,
                               compute_dtype=cd)
    scan = {"resident": cuda_lstm_scan, "tiled": cuda_lstm_tiled_scan}[route]
    return scan(params, xs, carry, mask=mask, reverse=reverse,
                compute_dtype=cd, plain_rounding=plain_rounding)


_ROUTES = ("residentx", "resident", "tiled")


class _KernelForwardRecompute(torch.autograd.Function):
    """The forward kernel's values with the plain recompute backward (JAX
    ``_scan_core_bwd``'s recompute branch): the backward re-runs
    :func:`lstm_scan` with ``remat_chunk`` (in the compute dtype) under
    autograd and pulls the cotangents through it."""

    @staticmethod
    def forward(ctx, spec, xs, h0, c0, *gates):
        fwd, mask, remat_chunk, cd = spec
        (hT, cT), ys = _route_scan(fwd, LSTMParams(*gates), xs, (h0, c0),
                                   mask, False, cd)
        ctx.spec = spec
        ctx.save_for_backward(xs, h0, c0, *gates)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        _, mask, remat_chunk, cd = ctx.spec
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            xs, h0, c0, *gates = leaves
            (hT, cT), ys = lstm_scan(LSTMParams(*gates), xs, (h0, c0),
                                     mask=mask, remat_chunk=remat_chunk,
                                     compute_dtype=cd)
            grads = torch.autograd.grad((ys, hT, cT), leaves, (dys, dhT, dcT))
        return (None, *grads)


def kernel_lstm_scan(params: LSTMParams, xs: torch.Tensor, carry=None, *,
                     mask: torch.Tensor | None = None, reverse: bool = False,
                     remat_chunk: int | None = None, compute_dtype=None,
                     plain_rounding: bool = False):
    """:func:`lstm_scan`'s contract through the kernels that
    :func:`chosen_bwd_strategy` picks (on CPU tensors their plain
    versions run, which is how the tests reach each route).
    ``plain_rounding`` runs :func:`chosen_fwd_strategy`'s forward alone,
    rounding as the plain loop does (no gradient flows)."""
    B, T, D = xs.shape
    H = params.hidden_size
    cd = resolve_dtype(compute_dtype)
    on_card = xs.device.type == "cuda"
    num_sms = cuda_lstm._num_sms(xs.device) if on_card else 132
    dev = xs.device if on_card else None
    _check_remat(T, remat_chunk)
    if plain_rounding:
        fwd = chosen_fwd_strategy(B, T, H, D, num_sms=num_sms, dev=dev,
                                  esize=cuda_lstm.esize_of(cd))
        return _route_scan(fwd, params, xs, carry, mask, reverse, cd, True)
    bwd = chosen_bwd_strategy(B, T, H, D, remat_chunk=remat_chunk,
                              num_sms=num_sms, dev=dev, esize=cuda_lstm.esize_of(cd))
    if bwd in _ROUTES:
        return _route_scan(bwd, params, xs, carry, mask, reverse, cd)
    fwd = chosen_fwd_strategy(B, T, H, D, num_sms=num_sms, dev=dev,
                              esize=cuda_lstm.esize_of(cd))
    if reverse:
        xs = torch.flip(xs, dims=(1,))
        if mask is not None:
            mask = torch.flip(mask, dims=(1,))
    if carry is None:
        carry = zero_carry(B, H, device=xs.device)
    ys, hT, cT = _KernelForwardRecompute.apply(
        (fwd, mask, remat_chunk, cd), xs, carry[0], carry[1], *params)
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
                   remat_chunk: int | None = None, bptt: str = "sequential",
                   compute_dtype=None, plain_rounding: bool = False):
    """:func:`lstm_scan`'s contract, through the kernels for CUDA tensors
    (:func:`kernel_lstm_scan`, ``plain_rounding`` included) and the plain
    loop for CPU tensors (whose rounding is the plain one).
    ``bptt="auto"`` is the sequential backward (the parallel-scan backward
    it could pick is not ported); an explicit ``"assoc"`` raises."""
    _check_bptt(bptt)
    if xs.device.type == "cuda":
        return kernel_lstm_scan(params, xs, carry, mask=mask, reverse=reverse,
                                remat_chunk=remat_chunk,
                                compute_dtype=compute_dtype,
                                plain_rounding=plain_rounding)
    return lstm_scan(params, xs, carry, mask=mask, reverse=reverse,
                     remat_chunk=remat_chunk, compute_dtype=compute_dtype)


def bidir_route(B: int, T: int, H_fwd: int, H_bwd: int, D: int, *,
                remat_chunk: int | None = None, bptt: str = "sequential",
                num_sms: int = 132, esize: int = 4) -> str:
    """How a CUDA bi-LSTM layer runs (JAX ``bidir_lstm_scan``'s gate):
    ``"stacked"`` — one launch of the stacked pair — when there is no
    ``remat_chunk``, no explicit assoc BPTT and :func:`bilstm_supported`
    (at ``esize`` bytes an element of U: 2 under bfloat16 compute); else
    ``"two_scans"``."""
    if (remat_chunk is None and bptt != "assoc" and H_fwd == H_bwd
            and bilstm_supported(B, H_fwd, D, T, num_sms, esize)):
        return "stacked"
    return "two_scans"


def bidir_lstm_scan(params_fwd: LSTMParams, params_bwd: LSTMParams,
                    xs: torch.Tensor, *, mask: torch.Tensor | None = None,
                    remat_chunk: int | None = None, bptt: str = "sequential",
                    compute_dtype=None):
    """Both directions of one bi-LSTM layer over ``xs`` [B, T, D], zero
    initial carries, ``compute_dtype`` (None / float32, or bfloat16) for
    both. Returns ``(((hT_f, cT_f), ys_f), ((hT_b, cT_b), ys_b))``."""
    B, T, D = xs.shape
    esize = cuda_lstm.esize_of(resolve_dtype(compute_dtype))
    if xs.device.type == "cuda" and bidir_route(
            B, T, params_fwd.hidden_size, params_bwd.hidden_size, D,
            remat_chunk=remat_chunk, bptt=bptt,
            num_sms=cuda_lstm._num_sms(xs.device), esize=esize) == "stacked":
        return cuda_bilstm_scan(params_fwd, params_bwd, xs, mask=mask,
                                compute_dtype=compute_dtype)
    out_f = auto_lstm_scan(params_fwd, xs, mask=mask, remat_chunk=remat_chunk,
                           bptt=bptt, compute_dtype=compute_dtype)
    out_b = auto_lstm_scan(params_bwd, xs, mask=mask, reverse=True,
                           remat_chunk=remat_chunk, bptt=bptt,
                           compute_dtype=compute_dtype)
    return out_f, out_b


def stacked_lstm_scan(layer_params: Sequence[LSTMParams], xs: torch.Tensor,
                      carries=None, *, mask: torch.Tensor | None = None,
                      reverse: bool = False, remat_chunk: int | None = None,
                      bptt: str = "sequential", dropout_rate: float = 0.0,
                      dropout_gen: torch.Generator | None = None,
                      dropout_keeps: Iterator[torch.Tensor] | None = None,
                      compute_dtype=None, plain_rounding: bool = False):
    """Stack layers over the same time axis, each through
    :func:`auto_lstm_scan`. With ``dropout_rate`` > 0 and a source of keep
    masks — drawn from ``dropout_gen``, or taken in order from
    ``dropout_keeps`` (the tests feed JAX's) — inverted dropout is applied
    to the full [B, T, H] output between layers, never after the top layer
    (JAX ``stacked_lstm_scan``; no source is its ``deterministic``).
    ``compute_dtype`` and ``plain_rounding`` go to every layer's scan.
    Returns (per-layer final carries, top-layer outputs [B, T, H])."""
    ys = xs
    finals = []
    n = len(layer_params)
    for idx, p in enumerate(layer_params):
        c0 = None if carries is None else carries[idx]
        final, ys = auto_lstm_scan(p, ys, c0, mask=mask, reverse=reverse,
                                   remat_chunk=remat_chunk, bptt=bptt,
                                   compute_dtype=compute_dtype,
                                   plain_rounding=plain_rounding)
        finals.append(final)
        if idx < n - 1 and dropout_rate > 0.0:
            if dropout_keeps is not None:
                ys = dropout_with_keep(next(dropout_keeps), dropout_rate, ys)
            elif dropout_gen is not None:
                ys = dropout(dropout_gen, dropout_rate, ys)
    return finals, ys
