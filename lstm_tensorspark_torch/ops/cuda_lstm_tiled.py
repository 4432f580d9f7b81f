"""The wide LSTM recurrence on the card: hand-written CUDA kernels for the
forward and the fused backward when U is too big for a cluster's shared
memory, and the autograd Function that joins them.

Counterpart of ``lstm_tensorspark_tpu/ops/pallas_lstm.py`` on its "tiled"
path: ``csrc/lstm_tiled_fwd.cu`` replaces ``_lstm_tiled_kernel`` and
``csrc/lstm_tiled_bwd.cu`` replaces ``_lstm_bwd_tiled_kernel``. The TPU
kernels stream U in row tiles every step; these keep it in the card's
shared memory taken together — one persistent block per SM owns a slice
of hidden units and U's gate columns for them — and join the blocks with
one grid-wide barrier a step (a cooperative launch).

The contract and the residuals are the resident pair's
(``ops/cuda_lstm.py``): the forward ``(xproj [T,B,4H], U [H,4H], h0, c0,
mask [T,B] float32 or None) -> (ys [T,B,H], hT, cT[, z [T,B,4H], cs
[T,B,H]])``, the backward ``(z, c0, cs, dys, U, dhT, dcT, mask) -> (dz
[T,B,4H], dh0, dc0)``. Their plain versions are
``cuda_lstm.lstm_forward_reference`` / ``lstm_backward_reference``, which a
CPU tensor runs; a CUDA tensor launches the kernel or raises.

- :func:`plan` is the launch plan (testable on the CPU); it raises
  ``ValueError`` for a shape whose shared memory does not fit a block.
- :class:`LSTMTiledRecurrence` is the autograd Function (dU one matmul
  outside, as ``_pallas_backward`` does); :func:`lstm_tiled_recurrence`
  and :func:`cuda_lstm_tiled_scan` are the entries ``ops/scan.py`` routes
  to.
- :data:`fwd_counts` / :data:`bwd_counts` count launches and plain runs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from . import cuda_lstm
from .cuda_lstm import (lstm_backward_reference, lstm_forward_reference,
                        recurrence_backward, recurrence_forward)
from .lstm_cell import LSTMParams

THREADS = 256  # csrc/lstm_tiled_*.cu THREADS
MAX_SMEM_BYTES = 232448  # 227 KB per block (csrc MAX_SMEM_BYTES)
MIN_SPLIT = 32  # fewest terms of a split sum
MIN_KTILE = 32  # fewest rows of H in a staged h tile

fwd_counts = kernels.LaunchCounts()
bwd_counts = kernels.LaunchCounts()


class TiledPlan(NamedTuple):
    """How a call is cut: ``blocks`` persistent blocks (at most one per
    SM), each owning ``units`` hidden units and U's gate columns for them;
    the forward stages h in tiles of ``ktile`` rows of H and splits each
    tile's sum ``ksplit`` ways; the backward splits its sum of dh over the
    blocks ``ksplit`` ways (``ktile`` = H). ``smem_bytes`` is what one
    block asks for."""

    blocks: int
    units: int
    ktile: int
    ksplit: int
    smem_bytes: int


def plan(kind: str, B: int, H: int, num_sms: int = 132) -> TiledPlan:
    """The launch plan of the ``"fwd"`` or ``"bwd"`` kernel for B rows of
    width H on a card with ``num_sms`` SMs. Mirrors the shared-memory
    layouts at the top of ``csrc/lstm_tiled_fwd.cu`` / ``lstm_tiled_bwd.cu``.
    Raises ``ValueError`` when the U slice and the buffers do not fit a
    block's shared memory."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"kind must be 'fwd' or 'bwd', got {kind!r}")
    if B < 1 or H < 1 or num_sms < 1:
        raise ValueError(f"need B, H, num_sms >= 1, got B={B}, H={H}, "
                         f"num_sms={num_sms}")
    units = -(-H // num_sms)
    blocks = -(-H // units)  # no block without units
    nc, b4 = 4 * units, -(-B // 4) * 4
    cap = MAX_SMEM_BYTES // 4
    base = H * (nc + 4 if nc % 8 == 0 else nc)  # the U slice (csrc w_stride)
    if kind == "fwd":
        base += 2 * b4 * units  # c and h of the own units
        items = nc * (b4 // 4)
        for ks in range(max(1, THREADS // items), 0, -1):
            kt = min(H, (cap - base - ks * b4 * nc) // b4)
            if kt >= min(H, MIN_KTILE):
                ks = min(ks, max(1, kt // MIN_SPLIT))
                floats = base + kt * b4 + ks * b4 * nc
                return TiledPlan(blocks, units, kt, ks, 4 * floats)
        floats = base + min(H, MIN_KTILE) * b4 + b4 * nc
    else:
        pairs = B * units
        ks = max(1, min(THREADS // pairs, blocks))
        floats = base + nc * b4 + 3 * b4 * units + ks * pairs
        if floats <= cap:
            return TiledPlan(blocks, units, H, ks, 4 * floats)
    raise ValueError(
        f"lstm tiled {kind} kernel: B={B} H={H} needs {4 * floats} bytes of "
        f"shared memory per block (> {MAX_SMEM_BYTES})")


def fits(B: int, H: int, num_sms: int = 132) -> bool:
    """Whether both tiled kernels have a plan for B rows of width H."""
    try:
        plan("fwd", B, H, num_sms)
        plan("bwd", B, H, num_sms)
    except ValueError:
        return False
    return True


# ---------------------------------------------------------------------------
# dispatch and the kernel launches
# ---------------------------------------------------------------------------


def lstm_tiled_forward(xproj, U, h0, c0, mask=None, *,
                       save_residuals: bool = False):
    """Forward recurrence with ``cuda_lstm.lstm_forward``'s contract. CUDA
    tensors launch ``csrc/lstm_tiled_fwd.cu``; CPU tensors run the plain
    version."""
    if xproj.device.type == "cuda":
        return _launch_fwd(xproj, U, h0, c0, mask, save_residuals)
    if xproj.device.type == "cpu":
        fwd_counts.bump("reference")
        return lstm_forward_reference(xproj, U, h0, c0, mask,
                                      save_residuals=save_residuals)
    raise ValueError(f"unsupported device {xproj.device}")


def lstm_tiled_backward(z, c0, cs, dys, U, dhT, dcT, mask=None):
    """Fused BPTT with ``cuda_lstm.lstm_backward``'s contract: returns
    ``(dz [T,B,4H], dh0, dc0)``. CUDA tensors launch
    ``csrc/lstm_tiled_bwd.cu``; CPU tensors run the plain version."""
    if z.device.type == "cuda":
        return _launch_bwd(z, c0, cs, dys, U, dhT, dcT, mask)
    if z.device.type == "cpu":
        bwd_counts.bump("reference")
        c_prev = torch.cat([c0[None], cs[:-1]], dim=0)
        return lstm_backward_reference(z, c_prev, dys, U, dhT, dcT, mask)
    raise ValueError(f"unsupported device {z.device}")


_p, _i = ctypes.c_void_p, ctypes.c_int
# csrc/lstm_tiled_fwd.cu::lstm_tiled_fwd_launch: 11 pointers, T, B, H, UPB,
# KT, KS, the stream; lstm_tiled_bwd_launch: 12 pointers, T, B, H, UPB, P,
# the stream
_FWD_ARGTYPES = [_p] * 11 + [_i] * 6 + [_p]
_BWD_ARGTYPES = [_p] * 12 + [_i] * 5 + [_p]


def _shape(name, t):
    if t.dim() != 3 or t.shape[2] % 4 or t.shape[0] < 1:
        raise ValueError(f"{name} must be [T >= 1, B, 4H], got "
                         f"{tuple(t.shape)}")
    T, B, G = t.shape
    return T, B, G // 4


def _launch_fwd(xproj, U, h0, c0, mask, save_residuals):
    dev = xproj.device
    T, B, H = _shape("xproj", xproj)
    kernels.check_f32("xproj", xproj, (T, B, 4 * H), dev)
    kernels.check_f32("U", U, (H, 4 * H), dev)
    kernels.check_f32("h0", h0, (B, H), dev)
    kernels.check_f32("c0", c0, (B, H), dev)
    cuda_lstm._check_mask(mask, T, B, dev)
    pl = plan("fwd", B, H, cuda_lstm._num_sms(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    ys = torch.empty((T, B, H), **f32)
    hT = torch.empty((B, H), **f32)
    cT = torch.empty((B, H), **f32)
    hbuf = torch.empty((2, H, -(-B // 4) * 4), **f32)
    z = cs = None
    if save_residuals:
        z = torch.empty((T, B, 4 * H), **f32)
        cs = torch.empty((T, B, H), **f32)
    launch = kernels.launcher("lstm_tiled_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            xproj.data_ptr(), U.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            cuda_lstm._ptr(mask), ys.data_ptr(), hT.data_ptr(), cT.data_ptr(),
            cuda_lstm._ptr(z), cuda_lstm._ptr(cs), hbuf.data_ptr(), T, B, H,
            pl.units, pl.ktile, pl.ksplit, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_tiled_fwd kernel launch failed: CUDA error "
                           f"{rc} (T={T} B={B} H={H}, {pl})")
    fwd_counts.bump("kernel")
    return (ys, hT, cT, z, cs) if save_residuals else (ys, hT, cT)


def _launch_bwd(z, c0, cs, dys, U, dhT, dcT, mask):
    dev = z.device
    T, B, H = _shape("z", z)
    kernels.check_f32("z", z, (T, B, 4 * H), dev)
    kernels.check_f32("c0", c0, (B, H), dev)
    kernels.check_f32("cs", cs, (T, B, H), dev)
    kernels.check_f32("dys", dys, (T, B, H), dev)
    kernels.check_f32("U", U, (H, 4 * H), dev)
    kernels.check_f32("dhT", dhT, (B, H), dev)
    kernels.check_f32("dcT", dcT, (B, H), dev)
    cuda_lstm._check_mask(mask, T, B, dev)
    pl = plan("bwd", B, H, cuda_lstm._num_sms(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    dz = torch.empty((T, B, 4 * H), **f32)
    dh0 = torch.empty((B, H), **f32)
    dc0 = torch.empty((B, H), **f32)
    part = torch.empty((2, pl.blocks, B, H), **f32)
    launch = kernels.launcher("lstm_tiled_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            z.data_ptr(), dys.data_ptr(), cs.data_ptr(), c0.data_ptr(),
            cuda_lstm._ptr(mask), U.data_ptr(), dhT.data_ptr(),
            dcT.data_ptr(), dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            part.data_ptr(), T, B, H, pl.units, pl.ksplit, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_tiled_bwd kernel launch failed: CUDA error "
                           f"{rc} (T={T} B={B} H={H}, {pl})")
    bwd_counts.bump("kernel")
    return dz, dh0, dc0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class LSTMTiledRecurrence(torch.autograd.Function):
    """``cuda_lstm.LSTMRecurrence`` through the tiled pair: ``(xproj, U,
    h0, c0, mask) -> (ys, hT, cT)``, z and cs saved for the fused
    backward."""

    @staticmethod
    def forward(ctx, xproj, U, h0, c0, mask):
        return recurrence_forward(ctx, lstm_tiled_forward, xproj, U, h0, c0,
                                  mask)

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        return recurrence_backward(ctx, lstm_tiled_backward, dys, dhT, dcT)


def lstm_tiled_recurrence(xproj, U, h0, c0, mask=None):
    """The recurrence through the tiled pair (``cuda_lstm.run_recurrence``:
    the Function when autograd needs it, the forward alone otherwise)."""
    return cuda_lstm.run_recurrence(LSTMTiledRecurrence, lstm_tiled_forward,
                                    xproj, U, h0, c0, mask)


def cuda_lstm_tiled_scan(params: LSTMParams, xs: torch.Tensor, carry=None, *,
                         mask: torch.Tensor | None = None,
                         reverse: bool = False):
    """One LSTM layer over ``xs`` [B, T, D] through the tiled pair, with
    ``ops.scan.lstm_scan``'s contract."""
    return cuda_lstm.cuda_lstm_scan(params, xs, carry, mask=mask,
                                    reverse=reverse,
                                    recurrence=lstm_tiled_recurrence)
