"""The "residentx" LSTM recurrence on the card: hand-written CUDA kernels
that compute the input projection inside the kernel and rebuild z in the
backward, for one direction or both directions of a bi-LSTM layer; their
plain PyTorch versions; and the autograd Function that joins them.

Counterpart of the residentx pair of ``lstm_tensorspark_tpu/ops/
pallas_lstm.py`` and of ``ops/pallas_bilstm.py``: ``csrc/lstmx_fwd.cu``
replaces ``_lstm_fwdx_kernel`` (launched with one direction) and
``_bi_fwdx_kernel`` (two directions); ``csrc/lstmx_bwd.cu`` replaces
``_lstm_bwdx_kernel`` and ``_bi_bwdx_kernel``.

Operands are time-major and direction-stacked: ``xs`` [T, ND*B, D] with
rows ``[d*B, (d+1)*B)`` belonging to direction d, ``W`` [ND, D, 4H], ``b``
[ND, 4H], ``U`` [ND, H, 4H], carries [ND*B, H], mask float32 [T, ND*B]
(1 = step, 0 = frozen carry). Float32, gate order i, f, g, o.

- :func:`lstmx_forward` / :func:`lstmx_backward` dispatch: a CUDA tensor
  launches the kernel or raises; a CPU tensor runs
  :func:`lstmx_forward_reference` / :func:`lstmx_backward_reference`.
- :class:`LSTMXRecurrence` is the autograd Function ``(xs, W, b, U, h0,
  c0, mask) -> (ys, hT, cT)``. It saves the cell states only (z is rebuilt
  in the backward, as the JAX pair does) and contracts dW, db, dU and
  dxs = dz @ Wᵀ over T·B outside the kernel, per direction.
- :func:`cuda_lstmx_scan` is the single-direction layer entry with
  ``lstm_scan``'s signature; ``ops/cuda_bilstm.py`` stacks two directions.
- :func:`plan` cuts the work (testable on the CPU); :func:`card_plan`
  gives it a card's SM count and resident clusters (:func:`max_clusters`).
- Launch counters: :data:`fwdx_counts` / :data:`bwdx_counts` (one
  direction), :data:`bi_fwdx_counts` / :data:`bi_bwdx_counts` (two).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from .cuda_lstm import (MAX_CLUSTER, MAX_SMEM_BYTES, MIN_SPLIT, THREADS,
                        UNITS_PER_BLOCK, _num_sms, _ptr, lstm_backward_reference,
                        lstm_forward_reference)
from .lstm_cell import LSTMParams, fuse_params

# The JAX package prefers the residentx pair from this sequence length on
# (pallas_lstm._FUSEDX_MIN_T): the [T, B, 4H] xproj and z streams it saves
# grow with T while its in-kernel projection costs a fixed share per step.
FUSEDX_MIN_T = 256
# Above this many bytes of saved residuals the JAX package trains with the
# recompute backward instead (pallas_lstm._RESIDUAL_HBM_BUDGET's default).
RESIDUAL_BUDGET_BYTES = 4096 * 2**20
CHUNKS = (8, 4, 2, 1)  # projection chunk lengths, largest first

fwdx_counts = kernels.LaunchCounts()
bwdx_counts = kernels.LaunchCounts()
bi_fwdx_counts = kernels.LaunchCounts()
bi_bwdx_counts = kernels.LaunchCounts()


def _counts(kind: str, ndir: int) -> kernels.LaunchCounts:
    if kind == "fwd":
        return fwdx_counts if ndir == 1 else bi_fwdx_counts
    return bwdx_counts if ndir == 1 else bi_bwdx_counts


class KernelPlan(NamedTuple):
    """How one kernel of the pair is cut: clusters of ``rows`` rows of one
    direction (``rows4`` rounded up to 4), ``groups`` clusters per
    direction, its product split ``ksplit`` (the forward's h @ U pieces,
    which are the plan's ``zks``; the backward's lanes that share a unit's
    dz @ Uᵀ sum), the projection chunk (steps; the backward's z rebuild
    takes one per block), whether the block's slice of U (forward) or Uᵀ
    (backward) sits in shared memory or (backward) in its lanes'
    registers, and the bytes of shared memory one block asks for (the
    backward: its chain kernel)."""

    rows: int
    rows4: int
    groups: int
    ksplit: int
    chunk: int
    u_in_smem: bool
    smem_bytes: int
    u_in_regs: bool = False


class XPlan(NamedTuple):
    """The pair's plan: clusters of ``cluster`` blocks, each block owning
    ``units`` hidden units; the h @ U sum in ``zks`` pieces in both kernels
    (the backward rebuilds z in the forward's order, which depends on H
    alone, so the two kernels may cut their rows differently); and each
    kernel's :class:`KernelPlan`."""

    cluster: int
    units: int
    zks: int
    fwd: KernelPlan
    bwd: KernelPlan


# a kernel takes clusters that all fit on the card at once only if that
# leaves it a projection chunk of at least this many steps
MIN_ONE_WAVE_CHUNK = 4
# csrc/lstmx_bwd.cu: the threads of a chain block (the dependent steps),
# the factors per element of the stream its z rebuild leaves, and the terms
# of dz @ Uᵀ a lane keeps in registers
BWD_THREADS = 256
BWD_PLANES = 8
BWD_UT_REG = 64


def _fit(base: int, per_chunk: int, w: int, what: str, B, H, D, ndir):
    """(chunk, u_in_smem, bytes): the U or Uᵀ slice in shared memory if any
    chunk allows it, else read through L2; the largest chunk that fits."""
    for u_in_smem in (True, False):
        for c in CHUNKS:
            n = 4 * (base + c * per_chunk + (w if u_in_smem else 0))
            if n <= MAX_SMEM_BYTES:
                return c, u_in_smem, n
    raise ValueError(
        f"lstmx {what} kernel: B={B} H={H} D={D} ndir={ndir} needs "
        f"{4 * (base + per_chunk)} bytes of shared memory per block "
        f"(> {MAX_SMEM_BYTES})")


def _rebuild_floats(H: int, D: int, upc: int, rows4: int, chunk: int) -> int:
    """Shared memory of the backward's z rebuild (``csrc/lstmx_bwd.cu``
    factors_smem_floats): a chunk's staged inputs (then its h_prev) and its
    rebuilt z."""
    e = chunk * rows4
    return max(D, H) * (e + 4) + e * 4 * upc


def factor_floats(T: int, ndir: int, xplan: "XPlan") -> int:
    """Floats of the factor stream the backward's rebuild writes and its
    chain reads: per step, row group and row quad, BWD_PLANES float4s of
    four rows for each unit of a cluster."""
    kp = xplan.bwd
    return 4 * T * ndir * kp.groups * (kp.rows4 // 4) * BWD_PLANES \
        * xplan.cluster * xplan.units


def cluster_units(H: int) -> tuple[int, int]:
    """(blocks per cluster, hidden units per block) for hidden size H."""
    cs = min(MAX_CLUSTER, -(-H // UNITS_PER_BLOCK))
    upc = -(-H // cs)
    return -(-H // upc), upc  # no block without units


def _row_groups(B: int, per_dir: int) -> tuple[int, int, int]:
    """(rows, rows4, groups) that cut B rows into at most ``per_dir``
    clusters, rows a multiple of 4 unless one cluster takes all B."""
    rows = -(-B // max(1, per_dir))
    rows = min(B, -(-rows // 4) * 4)
    return rows, -(-rows // 4) * 4, -(-B // rows)


def plan(B: int, H: int, D: int, ndir: int = 1, num_sms: int = 132,
         max_clusters: int | None = None) -> XPlan:
    """The launch plan of the pair for ``ndir`` directions of B rows each,
    hidden size H and input width D, on a card with ``num_sms`` SMs that
    keeps ``max_clusters`` clusters resident at once (default: every
    cluster of ``num_sms // cluster``). Each kernel takes the rows that
    fit all its clusters in one wave when that leaves it a projection
    chunk of ``MIN_ONE_WAVE_CHUNK`` steps, else the rows that spread it
    over ``num_sms // cluster`` clusters (a second wave when the card keeps
    fewer). Mirrors the shared-memory layouts at the top of
    ``csrc/lstmx_fwd.cu`` and ``csrc/lstmx_bwd.cu``. Raises ``ValueError``
    for a shape whose buffers do not fit a block."""
    if ndir not in (1, 2):
        raise ValueError(f"ndir must be 1 or 2, got {ndir}")
    if B < 1 or H < 1 or D < 1:
        raise ValueError(f"need B, H, D >= 1, got B={B}, H={H}, D={D}")
    cs, upc = cluster_units(H)
    G, NC = 4 * H, 4 * upc
    # the h @ U pieces depend on H alone, so the forward and the backward
    # sum them alike whatever their rows
    zks = max(1, min(THREADS // NC, H // MIN_SPLIT))

    def fwd(per_dir):
        rows, rows4, groups = _row_groups(B, per_dir)
        base = 2 * H * rows4 + rows4 * NC + rows4 * upc
        if zks > 1:
            base += zks * rows4 * NC
        base += 4 * D  # the staged inputs' row pad
        c, u, n = _fit(base, D * rows4 + rows4 * NC + rows4, H * NC, "fwd",
                       B, H, D, ndir)
        return KernelPlan(rows, rows4, groups, zks, c, u, n)

    def bwd(per_dir):
        rows, rows4, groups = _row_groups(B, per_dir)
        cap = 4 * max(1, BWD_THREADS // upc)  # a lane group per unit and
        if rows4 > cap:                        # row quad
            rows = rows4 = cap
            groups = -(-B // rows)
        lanes = 1
        while lanes * 2 <= min(32, BWD_THREADS // (upc * (rows4 // 4)),
                               G // MIN_SPLIT):
            lanes *= 2
        # the chain kernel: dz double buffer, two mbarriers, and Uᵀ's slice
        # (a row of 4H + lanes of padding per unit) unless the lanes' terms
        # fit their registers; the rebuild kernel: the staged rows and the
        # rebuilt z of a chunk
        base = 2 * G * rows4 + 4
        regs = -(-G // lanes) <= BWD_UT_REG
        smem = not regs and 4 * (base + (G + lanes) * upc) <= MAX_SMEM_BYTES
        n = 4 * (base + ((G + lanes) * upc if smem else 0))
        if n > MAX_SMEM_BYTES:
            raise ValueError(
                f"lstmx bwd kernel: B={B} H={H} D={D} ndir={ndir} needs {n} "
                f"bytes of shared memory per block (> {MAX_SMEM_BYTES})")
        c = next((c for c in CHUNKS if 4 * _rebuild_floats(
            H, D, upc, rows4, c) <= MAX_SMEM_BYTES), None)
        if c is None:
            raise ValueError(
                f"lstmx bwd rebuild: B={B} H={H} D={D} ndir={ndir} needs "
                f"{4 * _rebuild_floats(H, D, upc, rows4, 1)} bytes of shared "
                f"memory per block (> {MAX_SMEM_BYTES})")
        return KernelPlan(rows, rows4, groups, lanes, c, smem, n, regs)

    fill = max(1, (num_sms // cs) // ndir)
    wave = fill if max_clusters is None else max(1, min(
        fill, max_clusters // ndir))

    def pick(make):
        if wave < fill:
            try:
                p = make(wave)
                if p.chunk >= MIN_ONE_WAVE_CHUNK:
                    return p
            except ValueError:
                pass
        return make(fill)

    return XPlan(cs, upc, zks, pick(fwd), pick(bwd))


def fits(B: int, H: int, D: int, ndir: int = 1, num_sms: int = 132) -> bool:
    """Whether :func:`plan` finds a plan for these shapes (fewer resident
    clusters only change the rows, never whether a plan exists)."""
    try:
        plan(B, H, D, ndir, num_sms)
    except ValueError:
        return False
    return True


_max_clusters_cache: dict[tuple[int, int], int] = {}


def max_clusters(dev, cluster: int) -> int:
    """How many clusters of ``cluster`` blocks the card ``dev`` keeps
    resident at once when every block asks for the most shared memory (as
    the pair does at config-2 width; a smaller block may fit more, which
    only makes the plan cautious). Asked of the CUDA runtime once per card
    and cluster size."""
    key = (dev.index or 0, cluster)
    n = _max_clusters_cache.get(key)
    if n is None:
        fn = kernels.load("lstmx_fwd").lstmx_fwd_max_clusters
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = fn(cluster, MAX_SMEM_BYTES, ctypes.byref(out))
        if rc != 0 or out.value < 1:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA "
                               f"error {rc} (cluster={cluster}, {out.value})")
        n = _max_clusters_cache[key] = out.value
    return n


def card_plan(B: int, H: int, D: int, ndir: int, dev) -> XPlan:
    """:func:`plan` for the card ``dev``: its SM count and resident
    clusters."""
    return plan(B, H, D, ndir, _num_sms(dev),
                max_clusters(dev, cluster_units(H)[0]))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _rows(d: int, B: int) -> slice:
    return slice(d * B, (d + 1) * B)


def lstmx_forward_reference(xs, W, b, U, h0, c0, mask=None, *,
                            save_c: bool = False):
    """The forward of ``_lstm_fwdx_kernel`` / ``_bi_fwdx_kernel``: per
    direction ``zx = xs_d @ W_d + b_d``, then the steps ``z = zx_t + h @
    U_d``, the gates and the mask blend. Returns ``(ys, hT, cT)``, plus
    ``cs`` with ``save_c``."""
    ND = W.shape[0]
    B = xs.shape[1] // ND
    outs = []
    for d in range(ND):
        r = _rows(d, B)
        zx = xs[:, r] @ W[d] + b[d]
        m = None if mask is None else mask[:, r]
        outs.append(lstm_forward_reference(zx, U[d], h0[r], c0[r], m,
                                           save_residuals=save_c))
    ys = torch.cat([o[0] for o in outs], dim=1)
    hT = torch.cat([o[1] for o in outs], dim=0)
    cT = torch.cat([o[2] for o in outs], dim=0)
    if save_c:
        return ys, hT, cT, torch.cat([o[4] for o in outs], dim=1)
    return ys, hT, cT


def lstmx_backward_reference(xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT,
                             mask=None):
    """The backward of ``_lstm_bwdx_kernel`` / ``_bi_bwdx_kernel``: per
    direction, rebuild ``z = xs_d @ W_d + b_d + h_prev @ U_d`` (h_prev = h0,
    then ys[:-1]) and run the reverse cotangent algebra. Returns ``(dz
    [T, ND*B, 4H], dh0, dc0)``."""
    ND = W.shape[0]
    B = xs.shape[1] // ND
    h_prev = torch.cat([h0[None], ys[:-1]], dim=0)
    c_prev = torch.cat([c0[None], cs[:-1]], dim=0)
    outs = []
    for d in range(ND):
        r = _rows(d, B)
        z = (xs[:, r] @ W[d] + b[d]) + h_prev[:, r] @ U[d]
        m = None if mask is None else mask[:, r]
        outs.append(lstm_backward_reference(z, c_prev[:, r], dys[:, r], U[d],
                                            dhT[r], dcT[r], m))
    return (torch.cat([o[0] for o in outs], dim=1),
            torch.cat([o[1] for o in outs], dim=0),
            torch.cat([o[2] for o in outs], dim=0))


# ---------------------------------------------------------------------------
# dispatch and the kernel launches
# ---------------------------------------------------------------------------


def lstmx_forward(xs, W, b, U, h0, c0, mask=None, *, save_c: bool = False,
                  xplan: XPlan | None = None):
    """Forward of the pair: returns ``(ys [T, ND*B, H], hT, cT)`` and, with
    ``save_c``, ``cs`` [T, ND*B, H]. CUDA tensors launch
    ``csrc/lstmx_fwd.cu`` with ``xplan`` (default :func:`card_plan`); CPU
    tensors run the plain version."""
    if xs.device.type == "cuda":
        return _launch_fwd(xs, W, b, U, h0, c0, mask, save_c, xplan)
    if xs.device.type == "cpu":
        _counts("fwd", W.shape[0]).bump("reference")
        return lstmx_forward_reference(xs, W, b, U, h0, c0, mask,
                                       save_c=save_c)
    raise ValueError(f"unsupported device {xs.device}")


def lstmx_backward(xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask=None, *,
                   xplan: XPlan | None = None):
    """Backward of the pair from the forward's ``ys`` and ``cs``: returns
    ``(dz [T, ND*B, 4H], dh0, dc0)``. CUDA tensors launch
    ``csrc/lstmx_bwd.cu`` with ``xplan`` (default :func:`card_plan`); CPU
    tensors run the plain version."""
    if xs.device.type == "cuda":
        return _launch_bwd(xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask,
                           xplan)
    if xs.device.type == "cpu":
        _counts("bwd", W.shape[0]).bump("reference")
        return lstmx_backward_reference(xs, ys, h0, cs, c0, dys, W, b, U,
                                        dhT, dcT, mask)
    raise ValueError(f"unsupported device {xs.device}")


_p, _i = ctypes.c_void_p, ctypes.c_int
# csrc/lstmx_fwd.cu::lstmx_fwd_launch: 11 tensor pointers, T, B, ND, D, H
# and the eight plan ints, the stream; lstmx_bwd_launch: 18 pointers (the
# last two the factor scratch and its ready counts), the five shape ints
# and nine plan ints, the rebuild's stream and the chain's
_FWD_ARGTYPES = [_p] * 11 + [_i] * 13 + [_p]
_BWD_ARGTYPES = [_p] * 18 + [_i] * 14 + [_p] * 2


def _shapes(xs, W, U):
    if xs.dim() != 3 or W.dim() != 3 or U.dim() != 3:
        raise ValueError(f"xs [T, ND*B, D], W [ND, D, 4H], U [ND, H, 4H] "
                         f"expected, got {tuple(xs.shape)}, "
                         f"{tuple(W.shape)}, {tuple(U.shape)}")
    T, BS, D = xs.shape
    ND, H = U.shape[0], U.shape[1]
    if ND not in (1, 2) or BS % ND or T < 1:
        raise ValueError(f"bad stacked shapes: T={T}, rows={BS}, ND={ND}")
    return T, BS // ND, ND, D, H


def _check_weights(W, b, U, ND, D, H, dev):
    kernels.check_f32("W", W, (ND, D, 4 * H), dev)
    kernels.check_f32("b", b, (ND, 4 * H), dev)
    kernels.check_f32("U", U, (ND, H, 4 * H), dev)


def _launch_fwd(xs, W, b, U, h0, c0, mask, save_c, xplan):
    dev = xs.device
    T, B, ND, D, H = _shapes(xs, W, U)
    BS = ND * B
    kernels.check_f32("xs", xs, (T, BS, D), dev)
    _check_weights(W, b, U, ND, D, H, dev)
    kernels.check_f32("h0", h0, (BS, H), dev)
    kernels.check_f32("c0", c0, (BS, H), dev)
    if mask is not None:
        kernels.check_f32("mask", mask, (T, BS), dev)
    pl = xplan or card_plan(B, H, D, ND, dev)
    kp = pl.fwd
    ys = torch.empty((T, BS, H), dtype=torch.float32, device=dev)
    hT = torch.empty((BS, H), dtype=torch.float32, device=dev)
    cT = torch.empty((BS, H), dtype=torch.float32, device=dev)
    cs = (torch.empty((T, BS, H), dtype=torch.float32, device=dev)
          if save_c else None)
    launch = kernels.launcher("lstmx_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            xs.data_ptr(), W.data_ptr(), b.data_ptr(), U.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), _ptr(mask), ys.data_ptr(),
            hT.data_ptr(), cT.data_ptr(), _ptr(cs), T, B, ND, D, H,
            pl.cluster, pl.units, kp.rows, kp.rows4, kp.groups, pl.zks,
            kp.chunk, int(kp.u_in_smem), stream)
    if rc != 0:
        raise RuntimeError(f"lstmx_fwd kernel launch failed: CUDA error {rc} "
                           f"(T={T} B={B} ND={ND} D={D} H={H}, {pl})")
    _counts("fwd", ND).bump("kernel")
    return (ys, hT, cT, cs) if save_c else (ys, hT, cT)


# the backward's rebuild runs beside its chain only when the chain's
# blocks leave at least this many SMs free
REBUILD_MIN_SMS = 8
_rebuild_streams: dict[int, torch.cuda.Stream] = {}


def _rebuild_stream(dev) -> torch.cuda.Stream:
    """The side stream of the backward's z rebuild on card ``dev``."""
    key = dev.index or 0
    s = _rebuild_streams.get(key)
    if s is None:
        s = _rebuild_streams[key] = torch.cuda.Stream(dev)
    return s


def _launch_bwd(xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask, xplan):
    dev = xs.device
    T, B, ND, D, H = _shapes(xs, W, U)
    BS = ND * B
    kernels.check_f32("xs", xs, (T, BS, D), dev)
    for name, t in (("ys", ys), ("cs", cs), ("dys", dys)):
        kernels.check_f32(name, t, (T, BS, H), dev)
    for name, t in (("h0", h0), ("c0", c0), ("dhT", dhT), ("dcT", dcT)):
        kernels.check_f32(name, t, (BS, H), dev)
    _check_weights(W, b, U, ND, D, H, dev)
    if mask is not None:
        kernels.check_f32("mask", mask, (T, BS), dev)
    pl = xplan or card_plan(B, H, D, ND, dev)
    kp = pl.bwd
    ut = U.transpose(1, 2).contiguous()  # [ND, 4H, H]
    dz = torch.empty((T, BS, 4 * H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((BS, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((BS, H), dtype=torch.float32, device=dev)
    fac = torch.empty(factor_floats(T, ND, pl), dtype=torch.float32,
                      device=dev)
    ready = torch.zeros(-(-T // kp.chunk) * ND * kp.groups,
                        dtype=torch.int32, device=dev)
    launch = kernels.launcher("lstmx_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        cur = torch.cuda.current_stream(dev)
        # the rebuild beside the chain when the chain leaves it SMs (its
        # blocks wait for the chunks they need); else one after the other
        side = None
        if pl.cluster * kp.groups * ND <= _num_sms(dev) - REBUILD_MIN_SMS:
            side = _rebuild_stream(dev)
            side.wait_stream(cur)
        stream = cur.cuda_stream
        rc = launch(
            xs.data_ptr(), ys.data_ptr(), h0.data_ptr(), cs.data_ptr(),
            c0.data_ptr(), dys.data_ptr(), _ptr(mask), W.data_ptr(),
            b.data_ptr(), U.data_ptr(), ut.data_ptr(), dhT.data_ptr(),
            dcT.data_ptr(), dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            fac.data_ptr(), ready.data_ptr(), T, B, ND, D, H, pl.cluster,
            pl.units, kp.rows, kp.rows4, kp.groups, pl.zks, kp.ksplit,
            kp.chunk,
            0 if kp.u_in_regs else 1 if kp.u_in_smem else 2,
            (side or cur).cuda_stream, stream)
        if side is not None:
            cur.wait_stream(side)
    if rc != 0:
        raise RuntimeError(f"lstmx_bwd kernel launch failed: CUDA error {rc} "
                           f"(T={T} B={B} ND={ND} D={D} H={H}, {pl})")
    _counts("bwd", ND).bump("kernel")
    return dz, dh0, dc0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class LSTMXRecurrence(torch.autograd.Function):
    """``(xs [T, ND*B, D], W [ND, D, 4H], b [ND, 4H], U [ND, H, 4H], h0,
    c0, mask [T, ND*B] or None) -> (ys, hT, cT)`` through the residentx
    pair. Saves xs, ys and cs; no gradient flows to the mask."""

    @staticmethod
    def forward(ctx, xs, W, b, U, h0, c0, mask):
        ys, hT, cT, cs = lstmx_forward(xs, W, b, U, h0, c0, mask, save_c=True)
        ctx.save_for_backward(xs, W, b, U, h0, c0, mask, ys, cs)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        xs, W, b, U, h0, c0, mask, ys, cs = ctx.saved_tensors
        dz, dh0, dc0 = lstmx_backward(xs, ys, h0, cs, c0, dys.contiguous(), W,
                                      b, U, dhT.contiguous(),
                                      dcT.contiguous(), mask)
        T, BS, G = dz.shape
        ND, D, H = W.shape[0], W.shape[1], U.shape[1]
        B = BS // ND
        h_prev = torch.cat([h0[None], ys[:-1]], dim=0)
        dW, db, dU, dxs = [], [], [], []
        for d in range(ND):  # T·B contractions outside the kernel
            r = _rows(d, B)
            dz_d = dz[:, r].reshape(T * B, G)
            dW.append(xs[:, r].reshape(T * B, D).T @ dz_d)
            dU.append(h_prev[:, r].reshape(T * B, H).T @ dz_d)
            db.append(dz_d.sum(dim=0))
            dxs.append((dz_d @ W[d].T).reshape(T, B, D))
        return (torch.cat(dxs, dim=1), torch.stack(dW), torch.stack(db),
                torch.stack(dU), dh0, dc0, None)


def lstmx_recurrence(xs, W, b, U, h0, c0, mask=None):
    """The pair with the fused backward when autograd needs it; the forward
    alone, without the cs writes, otherwise (eval)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, W, b, U, h0, c0)):
        return LSTMXRecurrence.apply(xs, W, b, U, h0, c0, mask)
    return lstmx_forward(xs, W, b, U, h0, c0, mask)


def cuda_lstmx_scan(params: LSTMParams, xs: torch.Tensor, carry=None, *,
                    mask: torch.Tensor | None = None, reverse: bool = False):
    """One LSTM layer over ``xs`` [B, T, D] through the single-direction
    residentx pair, with ``lstm_scan``'s contract (``carry`` (h, c) or
    None; ``mask`` bool [B, T]; ``reverse``, a flip outside the Function).
    Returns ``((hT, cT), ys [B, T, H])``."""
    B, T, _ = xs.shape
    fused = fuse_params(params)
    H = fused.hidden_size
    if reverse:
        xs = torch.flip(xs, dims=(1,))
        if mask is not None:
            mask = torch.flip(mask, dims=(1,))
    if carry is None:
        h0 = torch.zeros((B, H), dtype=torch.float32, device=xs.device)
        c0 = torch.zeros_like(h0)
    else:
        h0, c0 = carry[0].contiguous(), carry[1].contiguous()
    m = None if mask is None else mask.transpose(0, 1).to(torch.float32).contiguous()
    ys, hT, cT = lstmx_recurrence(
        xs.transpose(0, 1).contiguous(), fused.kernel[None], fused.bias[None],
        fused.recurrent[None], h0, c0, m)
    ys = ys.transpose(0, 1)
    if reverse:
        ys = torch.flip(ys, dims=(1,))
    return (hT, cT), ys
