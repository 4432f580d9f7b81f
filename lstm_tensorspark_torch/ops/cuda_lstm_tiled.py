"""The wide LSTM recurrence on the card: hand-written CUDA kernels for the
forward and the fused backward when U is too big for a cluster's shared
memory, and the autograd Function that joins them.

Counterpart of ``lstm_tensorspark_tpu/ops/pallas_lstm.py`` on its "tiled"
path: ``csrc/lstm_tiled_fwd.cu`` replaces ``_lstm_tiled_kernel`` and
``csrc/lstm_tiled_bwd.cu`` replaces ``_lstm_bwd_tiled_kernel``. The TPU
kernels stream U in row tiles every step; these keep it on chip for the
whole call — one persistent block per SM, in clusters (of 2 for the
forward, of 4 or 2 for the backward), U in registers and shared memory.
The forward's block holds its units' gate columns over all of H and
its cluster shares the copy of h (TMA bulk copies multicast to every
block of the cluster); the backward's cluster holds its units' columns,
one slice of H a block, and sums a step's dz @ Uᵀ inside the cluster, so
one partial a cluster crosses L2. Steps hand over through counters in
global memory (no grid-wide barrier), so the launch is cooperative: CUDA
runs every block at once or refuses it, and the launcher refuses first a
grid whose clusters the card cannot keep resident at once.

The contract and the residuals are the resident pair's
(``ops/cuda_lstm.py``): the forward ``(xproj [T,B,4H], U [H,4H], h0, c0,
mask [T,B] float32 or None) -> (ys [T,B,H], hT, cT[, z [T,B,4H], cs
[T,B,H]])``, the backward ``(z, c0, cs, dys, U, dhT, dcT, mask) -> (dz
[T,B,4H], dh0, dc0)``. Their plain versions are
``cuda_lstm.lstm_forward_reference`` / ``lstm_backward_reference``, which a
CPU tensor runs; a CUDA tensor launches the kernel or raises. Each source
has the resident pair's two forms, float32 and bfloat16 (xproj, z, dz and
U bfloat16; h rounded at the product, dz at its store), chosen by the
dtype of xproj or z; the bfloat16 form keeps the lanes' U in registers as
float32 values and the rest of its share in shared memory as bfloat16.

- :func:`plan` is the launch plan (testable on the CPU); it raises
  ``ValueError`` for a shape no cluster size fits. :func:`card_plan` is
  the plan for a card's SMs and resident clusters (:func:`max_clusters`);
  :func:`fits` given the card reads the same plan, so the route and the
  launch cannot disagree.
- :class:`LSTMTiledRecurrence` is the autograd Function (dU one matmul
  outside, as ``_pallas_backward`` does); :func:`lstm_tiled_recurrence`
  and :func:`cuda_lstm_tiled_scan` are the entries ``ops/scan.py`` routes
  to.
- :data:`fwd_counts` / :data:`bwd_counts` count launches and plain runs;
  the bfloat16 forms and the forward's plain-rounding form (float32 xproj,
  bfloat16 U: ``cuda_lstm.forward_entry``) count apart.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from . import cuda_lstm
from .cuda_lstm import (check_backward, check_forward, counts_of, entry,
                        esize_of, lstm_backward_reference,
                        lstm_forward_reference, recurrence_backward,
                        recurrence_forward)
from .lstm_cell import LSTMParams

THREADS = 256  # csrc/tiled_common.cuh THREADS
WARPS = 8  # csrc WARPS
ROWS = 16  # csrc ROWS: batch rows of a tile
KREG = 64  # csrc KREG: U rows (fwd) / columns (bwd) a lane keeps in registers
MAX_UNITS = 16  # csrc MAX_UNITS: ROWS * units cell threads at most
RED_STRIDE = 20  # csrc/lstm_tiled_bwd.cu RED_STRIDE: a k's sums, padded
MAX_SMEM_BYTES = 232448  # 227 KB per block (csrc MAX_SMEM_BYTES)
# the cluster sizes each kernel's plan tries, in order. The forward runs
# clusters of 2: in clusters of 4 it measured slower at config 3's and
# config 5's widths, and no shape fits 4 alone. The backward tries 4
# first: faster at config 3's width (an H100, PERF.md; `python -m
# lstm_tensorspark_torch.phase_clocks clusters` times both sizes)
CLUSTERS = {"fwd": (2,), "bwd": (4, 2)}
# clusters of 4 blocks an H100 keeps resident at once at one block an SM
# (cudaOccupancyMaxActiveClusters; 66 of 2): the plan's default, scaled to
# the SM count, when it is not given the card's counts
H100_CLUSTERS_OF_4 = 30
# the pair's reach: a step's state (H x rows rounded up to 16, float32)
# under 2 MiB. That keeps the route where the parent design (U and a tile of
# h in one block's shared memory) had it: its widest shapes (B=724 at
# H=660, B=264 at H=1024) stay under, B=512 at H=1024 (2 MiB) does not
MAX_STATE_BYTES = 2 << 20

fwd_counts = kernels.LaunchCounts("lstm_tiled_fwd")
bwd_counts = kernels.LaunchCounts("lstm_tiled_bwd")
# the bfloat16 forms of the same sources
fwd_bf16_counts = kernels.LaunchCounts("lstm_tiled_fwd_bf16")
# the forward's plain-rounding form: xproj float32, U bfloat16
fwd_bf16u_counts = kernels.LaunchCounts("lstm_tiled_fwd_bf16u")
bwd_bf16_counts = kernels.LaunchCounts("lstm_tiled_bwd_bf16")


class TiledPlan(NamedTuple):
    """How a call is cut: ``blocks`` persistent blocks (at most one per
    SM) in clusters of ``cluster``, each block owning ``units`` hidden
    units (their cell). The batch goes in ``row_tiles`` tiles of 16 rows.
    Forward: a block holds U's gate columns of its units over all of H;
    a group of ``group_lanes`` lanes (two columns a lane) covers them at
    one row of H, ``groups`` groups take every ``groups``-th row,
    ``per_lane`` rows a lane; the cluster shares the copy of h (each
    block copies ``ceil(H / cluster)`` rows into all of them). Backward:
    a cluster owns ``cluster * units`` units, each block one slice of H
    (``ceil(H / cluster)`` rows) of their gate columns; a group of
    ``group_lanes`` lanes (two rows a lane) covers the slice, ``groups``
    groups split the columns, ``per_lane`` columns a lane. The first
    ``u_regs`` rows or columns a lane stay in registers, the rest in
    shared memory (``esize`` bytes an element: 2 in the bfloat16 form).
    ``smem_bytes`` is what one block asks for."""

    blocks: int
    cluster: int
    units: int
    row_tiles: int
    groups: int
    group_lanes: int
    per_lane: int
    u_regs: int
    smem_bytes: int


def _geometry(kind: str, B: int, H: int, C: int, units: int,
              esize: int = 4):
    """(groups, group_lanes, per_lane, u_regs, row_tiles, smem_bytes) of
    one block, or None when the warps cannot cover it. Mirrors
    ``fwd_geom`` / ``bwd_geom`` and the shared-memory layouts of
    ``csrc/lstm_tiled_fwd.cu`` / ``lstm_tiled_bwd.cu``: U's rows or
    columns past the registers take ``esize`` bytes an element, rounded up
    to 16 bytes; every other piece is float32."""
    hq = -(-H // C)
    bp = -(-B // ROWS) * ROWS
    carries = 2 * bp * units + 4  # c and h (dc and the skip), mbarriers
    if kind == "fwd":  # U rows past the registers, h, the groups' sums
        lanes = 2 * units
        groups = THREADS // lanes
        per_lane = -(-H // groups)
        regs = min(per_lane, KREG)
        u_rest = (per_lane - regs) * groups * 4 * units
        floats = (groups * max(per_lane, KREG) * ROWS
                  + groups * ROWS * (4 * units + 8))
    else:  # U^T columns past the registers, dz, j-group sums, the gather
        nc = 4 * C * units
        span = -(-hq // 64)  # warps a group
        if span > WARPS:
            return None
        groups, lanes = WARPS // span, 32 * span
        per_lane = -(-nc // groups)
        regs = min(per_lane, KREG)
        ncl = -(-H // (C * units))
        u_rest = groups * (per_lane - regs) * lanes
        floats = (2 * groups * per_lane * ROWS + groups * lanes * RED_STRIDE
                  + THREADS * 4 + ncl * units * ROWS)
    u_bytes = -(-esize * u_rest // 16) * 16
    return (groups, lanes, per_lane, regs, bp // ROWS,
            u_bytes + 4 * (floats + carries))


def plan(kind: str, B: int, H: int, num_sms: int = 132,
         max_clusters: dict | None = None, esize: int = 4) -> TiledPlan:
    """The launch plan of the ``"fwd"`` or ``"bwd"`` kernel for B rows of
    width H on a card with ``num_sms`` SMs that keeps ``max_clusters[C]``
    clusters of C blocks resident at once (default: an H100's counts
    scaled to ``num_sms``). Tries the kind's cluster sizes of
    :data:`CLUSTERS` in order: each takes as many clusters as the card
    keeps, the fewest units a block that cover H with them and fit shared
    memory; keeps the first plan whose U fits the lanes' registers, else
    the first that fits shared memory. ``esize`` is the bytes of an
    element of U in shared memory (2 in the bfloat16 forms). Raises
    ``ValueError`` when none fits or the state of a step reaches
    :data:`MAX_STATE_BYTES`."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"kind must be 'fwd' or 'bwd', got {kind!r}")
    if B < 1 or H < 1 or num_sms < 1:
        raise ValueError(f"need B, H, num_sms >= 1, got B={B}, H={H}, "
                         f"num_sms={num_sms}")
    state = 4 * H * -(-B // ROWS) * ROWS
    if state >= MAX_STATE_BYTES:
        raise ValueError(f"lstm tiled {kind} kernel: B={B} H={H} has a "
                         f"{state} byte state a step (>= {MAX_STATE_BYTES}, "
                         "the tiled route's reach)")
    best, why = None, []
    for C in CLUSTERS[kind]:
        if max_clusters is None:
            keep = (num_sms * H100_CLUSTERS_OF_4 // 132 if C == 4
                    else num_sms // C)
        else:
            keep = max_clusters.get(C, 0)
        keep = min(keep, num_sms // C)
        if keep < 1:
            why.append(f"the card keeps no cluster of {C}")
            continue
        units = -(-(-(-H // keep)) // C)
        if units > MAX_UNITS:
            why.append(f"{keep} resident clusters of {C} need {units} units "
                       f"a block (> {MAX_UNITS})")
            continue
        # more units a block where the fewest do not fit shared memory (at
        # a small H the forward's many slots stage a long zero tail of h)
        geo = _geometry(kind, B, H, C, units, esize)
        while (geo is not None and geo[-1] > MAX_SMEM_BYTES
               and units < MAX_UNITS):
            units += 1
            geo = _geometry(kind, B, H, C, units, esize)
        if geo is None:
            why.append(f"clusters of {C}: the slice is too wide for the warps")
            continue
        groups, lanes, per_lane, regs, tiles, smem = geo
        if smem > MAX_SMEM_BYTES:
            why.append(f"clusters of {C}: {smem} bytes of shared memory a "
                       f"block (> {MAX_SMEM_BYTES})")
            continue
        p = TiledPlan(C * -(-H // (C * units)), C, units, tiles, groups, lanes,
                      per_lane, regs, smem)
        if best is None or (p.per_lane <= KREG < best.per_lane):
            best = p
    if best is None:
        raise ValueError(f"lstm tiled {kind} kernel: no plan for B={B} H={H}: "
                         + "; ".join(why))
    return best


def fits(B: int, H: int, num_sms: int = 132, dev=None,
         esize: int = 4) -> bool:
    """Whether both tiled kernels have a plan for B rows of width H (U at
    ``esize`` bytes an element): on the card ``dev`` (:func:`card_plan`,
    what the launch runs) when it is given, else on ``num_sms`` SMs of an
    H100."""
    try:
        for kind in ("fwd", "bwd"):
            if dev is None:
                plan(kind, B, H, num_sms, esize=esize)
            else:
                card_plan(kind, B, H, dev, esize)
    except ValueError:
        return False
    return True


def max_clusters(dev) -> dict[int, int]:
    """How many clusters of 2 and of 4 blocks the card ``dev`` keeps
    resident at once at one block an SM
    (``csrc/lstm_tiled_fwd.cu::lstm_tiled_fwd_max_clusters``)."""
    return {C: kernels.max_clusters("lstm_tiled_fwd", dev, C, MAX_SMEM_BYTES)
            for C in (2, 4)}


def card_plan(kind: str, B: int, H: int, dev, esize: int = 4) -> TiledPlan:
    """:func:`plan` for the card ``dev``: its SM count and resident
    clusters."""
    return plan(kind, B, H, cuda_lstm._num_sms(dev), max_clusters(dev),
                esize)


# ---------------------------------------------------------------------------
# dispatch and the kernel launches
# ---------------------------------------------------------------------------


def lstm_tiled_forward(xproj, U, h0, c0, mask=None, *,
                       save_residuals: bool = False):
    """Forward recurrence with ``cuda_lstm.lstm_forward``'s contract. CUDA
    tensors launch ``csrc/lstm_tiled_fwd.cu`` (the card plan) in the form
    of xproj's dtype; CPU tensors run the plain version."""
    if xproj.device.type == "cuda":
        return _launch_fwd(xproj, U, h0, c0, mask, save_residuals)
    if xproj.device.type != "cpu":
        raise ValueError(f"unsupported device {xproj.device}")
    *_, sd = check_forward(xproj, U, h0, c0, mask)
    fwd_form_counts(xproj, sd).bump("reference")
    return lstm_forward_reference(xproj, U, h0, c0, mask,
                                  save_residuals=save_residuals)


def lstm_tiled_backward(z, c0, cs, dys, U, dhT, dcT, mask=None):
    """Fused BPTT with ``cuda_lstm.lstm_backward``'s contract: returns
    ``(dz [T,B,4H], dh0, dc0)``. CUDA tensors launch
    ``csrc/lstm_tiled_bwd.cu`` (the card plan) in the form of z's dtype;
    CPU tensors run the plain version."""
    if z.device.type == "cuda":
        return _launch_bwd(z, c0, cs, dys, U, dhT, dcT, mask)
    if z.device.type != "cpu":
        raise ValueError(f"unsupported device {z.device}")
    *_, sd = check_backward(z, c0, cs, dys, U, dhT, dcT, mask)
    counts_of(sd, bwd_counts, bwd_bf16_counts).bump("reference")
    c_prev = torch.cat([c0[None], cs[:-1]], dim=0)
    return lstm_backward_reference(z, c_prev, dys, U, dhT, dcT, mask)


_p, _i = ctypes.c_void_p, ctypes.c_int
# csrc/lstm_tiled_fwd.cu::lstm_tiled_fwd_launch (and _bf16_launch): 12
# pointers, T, B, H, C, UPB, the stream; lstm_tiled_bwd_launch (and
# _bf16_launch): 13 pointers, T, B, H, C, UPB, the stream
_FWD_ARGTYPES = [_p] * 12 + [_i] * 5 + [_p]
_BWD_ARGTYPES = [_p] * 13 + [_i] * 5 + [_p]


def _launch_fwd(xproj, U, h0, c0, mask, save_residuals):
    dev = xproj.device
    T, B, H, sd = check_forward(xproj, U, h0, c0, mask)
    cuda_lstm.check_plain_rounding(xproj, sd, save_residuals)
    pl = card_plan("fwd", B, H, dev, esize_of(sd))
    f32 = dict(dtype=torch.float32, device=dev)
    ys = torch.empty((T, B, H), **f32)
    hT = torch.empty((B, H), **f32)
    cT = torch.empty((B, H), **f32)
    hx = torch.empty((2, pl.row_tiles, H, ROWS), **f32)
    flags = torch.zeros(pl.cluster, dtype=torch.int32, device=dev)
    z = cs = None
    if save_residuals:
        z = torch.empty((T, B, 4 * H), dtype=sd, device=dev)
        cs = torch.empty((T, B, H), **f32)
    launch = kernels.launcher("lstm_tiled_fwd", _FWD_ARGTYPES,
                              cuda_lstm.forward_entry(xproj, sd))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            xproj.data_ptr(), U.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            cuda_lstm._ptr(mask), ys.data_ptr(), hT.data_ptr(), cT.data_ptr(),
            cuda_lstm._ptr(z), cuda_lstm._ptr(cs), hx.data_ptr(),
            flags.data_ptr(), T, B, H, pl.cluster, pl.units, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_tiled_fwd kernel launch failed: CUDA error "
                           f"{rc} (T={T} B={B} H={H}, {sd}, {pl})")
    fwd_form_counts(xproj, sd).bump("kernel")
    return (ys, hT, cT, z, cs) if save_residuals else (ys, hT, cT)


def fwd_form_counts(xproj, sd):
    """The launch counter of a tiled forward call's form."""
    return {"launch": fwd_counts, "bf16_launch": fwd_bf16_counts,
            "bf16u_launch": fwd_bf16u_counts}[
                cuda_lstm.forward_entry(xproj, sd)]


def _launch_bwd(z, c0, cs, dys, U, dhT, dcT, mask):
    dev = z.device
    T, B, H, sd = check_backward(z, c0, cs, dys, U, dhT, dcT, mask)
    pl = card_plan("bwd", B, H, dev, esize_of(sd))
    f32 = dict(dtype=torch.float32, device=dev)
    dz = torch.empty((T, B, 4 * H), dtype=sd, device=dev)
    dh0 = torch.empty((B, H), **f32)
    dc0 = torch.empty((B, H), **f32)
    part = torch.empty((2, pl.blocks // pl.cluster, H, pl.row_tiles * ROWS),
                       **f32)
    flags = torch.zeros(pl.cluster, dtype=torch.int32, device=dev)
    launch = kernels.launcher("lstm_tiled_bwd", _BWD_ARGTYPES, entry(sd))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            z.data_ptr(), dys.data_ptr(), cs.data_ptr(), c0.data_ptr(),
            cuda_lstm._ptr(mask), U.data_ptr(), dhT.data_ptr(),
            dcT.data_ptr(), dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            part.data_ptr(), flags.data_ptr(), T, B, H, pl.cluster, pl.units,
            stream)
    if rc != 0:
        raise RuntimeError(f"lstm_tiled_bwd kernel launch failed: CUDA error "
                           f"{rc} (T={T} B={B} H={H}, {sd}, {pl})")
    counts_of(sd, bwd_counts, bwd_bf16_counts).bump("kernel")
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
                         reverse: bool = False, compute_dtype=None,
                         plain_rounding: bool = False):
    """One LSTM layer over ``xs`` [B, T, D] through the tiled pair, with
    ``cuda_lstm.cuda_lstm_scan``'s contract."""
    return cuda_lstm.cuda_lstm_scan(params, xs, carry, mask=mask,
                                    reverse=reverse,
                                    recurrence=lstm_tiled_recurrence,
                                    compute_dtype=compute_dtype,
                                    plain_rounding=plain_rounding)
