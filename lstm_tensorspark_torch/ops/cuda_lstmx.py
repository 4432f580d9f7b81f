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
(1 = step, 0 = frozen carry). Gate order i, f, g, o.

Each kernel has two forms, chosen by the dtype of ``xs``: float32, and
bfloat16 (JAX's pair under bf16 compute, ``pallas_lstm._residual_dtype``),
where xs, W, U and the dz stream are bfloat16 and everything else float32.
The bfloat16 forward keeps its projection ``zx = xs @ W + b`` in float32
(JAX never rounds it) and rounds h to bfloat16 only at the product ``h @
U``; the backward rebuilds z from the same operands in the same order, so
z is the forward's to the bit, rounds dz once, at its store, and forms dh
from that rounded dz. Their launches count apart (:data:`fwdx_bf16_counts`
and the other ``*_bf16_counts``). A mixed call raises ``TypeError``.

- :func:`lstmx_forward` / :func:`lstmx_backward` dispatch: a CUDA tensor
  launches the kernel or raises; a CPU tensor runs
  :func:`lstmx_forward_reference` / :func:`lstmx_backward_reference`.
- :class:`LSTMXRecurrence` is the autograd Function ``(xs, W, b, U, h0,
  c0, mask, dtype) -> (ys, hT, cT)``: float32 operands, cast to ``dtype``
  inside (so the gradients leave in float32). It saves the cell states
  only (z is rebuilt in the backward, as the JAX pair does) and contracts
  dW, db, dU and dxs = dz @ Wᵀ over T·B outside the kernel, per direction
  (from bfloat16 operands with float32 sums in the bfloat16 form:
  ``lstm_cell.mm_f32``).
- :func:`cuda_lstmx_scan` is the single-direction layer entry with
  ``lstm_scan``'s signature; ``ops/cuda_bilstm.py`` stacks two directions.
- :func:`plan` cuts the work (testable on the CPU); :func:`card_plan`
  gives it a card's SM count and resident clusters (:func:`max_clusters`);
  :func:`forward_plan` is the forward's cut for a given number of clusters
  per direction, :func:`projection_sms` the SMs its chain leaves to its
  projection kernel.
- Launch counters: :data:`fwdx_counts` / :data:`bwdx_counts` (one
  direction), :data:`bi_fwdx_counts` / :data:`bi_bwdx_counts` (two), and
  the bfloat16 forms' :data:`fwdx_bf16_counts`, :data:`bwdx_bf16_counts`,
  :data:`bi_fwdx_bf16_counts`, :data:`bi_bwdx_bf16_counts`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from .cuda_lstm import (F32, MAX_CLUSTER, MAX_SMEM_BYTES, MIN_SPLIT, THREADS,
                        UNITS_PER_BLOCK, _num_sms, _ptr, entry, esize_of,
                        lstm_backward_reference, lstm_forward_reference,
                        stream_dtype)
from .lstm_cell import LSTMParams, fuse_params, mm_f32, resolve_dtype

# The JAX package prefers the residentx pair from this sequence length on
# (pallas_lstm._FUSEDX_MIN_T): the [T, B, 4H] xproj and z streams it saves
# grow with T while its in-kernel projection costs a fixed share per step.
FUSEDX_MIN_T = 256
# Above this many bytes of saved residuals the JAX package trains with the
# recompute backward instead (pallas_lstm._RESIDUAL_HBM_BUDGET's default).
RESIDUAL_BUDGET_BYTES = 4096 * 2**20
CHUNKS = (8, 4, 2, 1)  # the z rebuild's chunk lengths, largest first

fwdx_counts = kernels.LaunchCounts("lstmx_fwd")
bwdx_counts = kernels.LaunchCounts("lstmx_bwd")
bi_fwdx_counts = kernels.LaunchCounts("bi_lstmx_fwd")
bi_bwdx_counts = kernels.LaunchCounts("bi_lstmx_bwd")
# the bfloat16 forms of the same sources
fwdx_bf16_counts = kernels.LaunchCounts("lstmx_fwd_bf16")
bwdx_bf16_counts = kernels.LaunchCounts("lstmx_bwd_bf16")
bi_fwdx_bf16_counts = kernels.LaunchCounts("bi_lstmx_fwd_bf16")
bi_bwdx_bf16_counts = kernels.LaunchCounts("bi_lstmx_bwd_bf16")
_COUNTS = {("fwd", 1, F32): fwdx_counts, ("bwd", 1, F32): bwdx_counts,
           ("fwd", 2, F32): bi_fwdx_counts, ("bwd", 2, F32): bi_bwdx_counts,
           ("fwd", 1, torch.bfloat16): fwdx_bf16_counts,
           ("bwd", 1, torch.bfloat16): bwdx_bf16_counts,
           ("fwd", 2, torch.bfloat16): bi_fwdx_bf16_counts,
           ("bwd", 2, torch.bfloat16): bi_bwdx_bf16_counts}


def _counts(kind: str, ndir: int, dtype=F32) -> kernels.LaunchCounts:
    """The launch counter of one role (``"fwd"`` / ``"bwd"``, one or two
    directions) in ``dtype``'s form."""
    return _COUNTS[kind, ndir, dtype]


class KernelPlan(NamedTuple):
    """How one kernel of the pair is cut: clusters of ``rows`` rows of one
    direction (``rows4`` rounded up to 4), ``groups`` clusters per
    direction, its product split ``ksplit`` (the forward's h @ U pieces,
    which are the plan's ``zks``; the backward's lanes that share a unit's
    dz @ Uᵀ sum), the chunk of steps of its side kernel (the forward's
    projection tile, the backward's z rebuild block), whether the block's
    slice of U (forward) or Uᵀ (backward) sits in shared memory or in its
    threads' registers (else it is read through L2), and the bytes of
    shared memory the chain kernel's layout takes a block (in the form
    whose element size the plan was made for)."""

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


# the backward takes clusters that all fit on the card at once only if that
# leaves its z rebuild a chunk of at least this many steps
MIN_ONE_WAVE_CHUNK = 4
# a side kernel (the forward's projection, the backward's z rebuild) runs
# beside its chain only when the chain's blocks leave it at least this many
# SMs; else the two run one after the other
REBUILD_MIN_SMS = 8
# csrc/lstmx_fwd.cu: the rows of a projection tile (a chunk's steps times a
# group's rows), the most rows a cluster of the chain takes (two float4s of
# h a term), the terms of a piece of h @ U a thread keeps in registers (and
# the zero rows past H its h buffers then carry)
PROJ_ROWS = 64
FWD_MAX_ROWS = 8
FWD_U_REG = 128
FWD_UB_PAIRS = 64  # column pairs of the 8-row chain's shared second columns
# csrc/lstmx_bwd.cu: the threads of a chain block (the dependent steps),
# the factors per element of the stream its z rebuild leaves, and the terms
# of dz @ Uᵀ a lane keeps in registers
BWD_THREADS = 256
BWD_PLANES = 8
BWD_UT_REG = 64


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


def zx_floats(T: int, H: int, ndir: int, xplan: "XPlan") -> int:
    """Floats of the zx stream the forward's projection writes and its
    chain reads: per step, row group, unit and row, the unit's four gates."""
    kp = xplan.fwd
    return 4 * T * ndir * kp.groups * H * kp.rows4


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


def _zks(H: int, upc: int) -> int:
    """The pieces of h @ U; they depend on H alone, so the forward and the
    backward sum them alike whatever their rows."""
    return max(1, min(THREADS // (4 * upc), H // MIN_SPLIT))


def chain_bytes(H: int, upc: int, rows4: int, zks: int, u_in_smem: bool,
                u_in_regs: bool, esize: int = 4) -> int:
    """Shared memory of the forward's chain kernel (``csrc/lstmx_fwd.cu``
    chain_smem_bytes): h double-buffered (with ``FWD_U_REG`` zero rows when
    U sits in registers), the pieces of h @ U (the block's columns rounded
    up to a warp, rows + 1 a column), a step's zx double-buffered, c (and,
    in the bfloat16 form, h: the buffers then hold h rounded), the mask,
    two mbarriers — floats — and U's slice when it sits in shared memory
    (or, with U in registers and two row quads, the second column of each
    thread's pair), ``esize`` bytes an element (2 in the bfloat16 form)."""
    ncp = -(-4 * upc // 32) * 32
    red = -(-(zks * ncp * (rows4 + 1)) // 4) * 4
    pad = FWD_U_REG if u_in_regs else 0
    own = upc * rows4 if esize != 4 else 0
    # two row quads: each thread's second column from shared memory, a
    # piece's FWD_U_REG terms (zeros past it) a column of the pairs
    ub = zks * FWD_U_REG * FWD_UB_PAIRS if u_in_regs and rows4 == 8 else 0
    return (4 * (2 * (H + pad) * rows4 + red + 9 * upc * rows4 + own
                 + 2 * rows4 + 4)
            + esize * ((H * ncp if u_in_smem else 0) + ub))


def forward_plan(B: int, H: int, per_dir: int, esize: int = 4) -> KernelPlan:
    """The forward's cut with at most ``per_dir`` clusters a direction (more
    when a cluster would take more than ``FWD_MAX_ROWS`` rows): each
    thread's piece of h @ U in its registers when a piece has at most
    ``FWD_U_REG`` terms, else the block's slice of U in shared memory when
    it fits, else read through L2; the projection's chunk fills its tile of
    ``PROJ_ROWS`` rows; ``esize`` is the bytes of an element of U (2 in the
    bfloat16 form). Raises ``ValueError`` when the chain's buffers do not
    fit a block."""
    _, upc = cluster_units(H)
    zks = _zks(H, upc)
    rows, rows4, groups = _row_groups(B, per_dir)
    for cap in (FWD_MAX_ROWS, 4):
        if rows4 > cap:
            rows = rows4 = cap
            groups = -(-B // rows)
        regs = -(-H // zks) <= FWD_U_REG
        smem = not regs and chain_bytes(
            H, upc, rows4, zks, True, False, esize) <= MAX_SMEM_BYTES
        n = chain_bytes(H, upc, rows4, zks, smem, regs, esize)
        if n <= MAX_SMEM_BYTES:
            return KernelPlan(rows, rows4, groups, zks, PROJ_ROWS // rows4,
                              smem, n, regs)
    raise ValueError(
        f"lstmx fwd kernel: B={B} H={H} needs {n} bytes of shared memory "
        f"per block (> {MAX_SMEM_BYTES})")


def projection_sms(xplan: XPlan, ndir: int, num_sms: int) -> int:
    """The SMs the forward's chain leaves to its projection kernel (its
    blocks take an SM each); the two overlap when these are at least
    ``REBUILD_MIN_SMS``."""
    return num_sms - xplan.cluster * xplan.fwd.groups * ndir


def plan(B: int, H: int, D: int, ndir: int = 1, num_sms: int = 132,
         max_clusters: int | None = None, esize: int = 4) -> XPlan:
    """The launch plan of the pair for ``ndir`` directions of B rows each,
    hidden size H and input width D, on a card with ``num_sms`` SMs that
    keeps ``max_clusters`` clusters resident at once (default: every
    cluster of ``num_sms // cluster``). The forward takes the fewest rows
    whose clusters all fit on the card at once and leave its projection
    ``REBUILD_MIN_SMS`` SMs (:func:`forward_plan`). The backward takes the
    rows that fit all its clusters in one wave when that leaves its z
    rebuild a chunk of ``MIN_ONE_WAVE_CHUNK`` steps, else the rows that
    spread it over ``num_sms // cluster`` clusters (a second wave when the
    card keeps fewer). Mirrors the shared-memory layouts in
    ``csrc/lstmx_fwd.cu`` and ``csrc/lstmx_bwd.cu`` in the form whose U
    takes ``esize`` bytes an element (4, or 2 in the bfloat16 form, whose
    slices of U and Uᵀ in shared memory take half the room). Raises
    ``ValueError`` for a shape whose buffers do not fit a block."""
    if ndir not in (1, 2):
        raise ValueError(f"ndir must be 1 or 2, got {ndir}")
    if B < 1 or H < 1 or D < 1:
        raise ValueError(f"need B, H, D >= 1, got B={B}, H={H}, D={D}")
    cs, upc = cluster_units(H)
    G = 4 * H
    zks = _zks(H, upc)

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
        # the chain kernel: dz double buffer and two mbarriers (floats),
        # and Uᵀ's slice (a row of 4H + lanes of padding per unit, esize
        # bytes an element) unless the lanes' terms fit their registers;
        # the rebuild kernel: the staged rows and the rebuilt z of a chunk
        base = 4 * (2 * G * rows4 + 4)
        regs = -(-G // lanes) <= BWD_UT_REG
        ut = esize * (G + lanes) * upc
        smem = not regs and base + ut <= MAX_SMEM_BYTES
        n = base + (ut if smem else 0)
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

    free = max(1, ((num_sms - REBUILD_MIN_SMS) // cs) // ndir)
    return XPlan(cs, upc, zks, forward_plan(B, H, min(wave, free), esize),
                 pick(bwd))


def fits(B: int, H: int, D: int, ndir: int = 1, num_sms: int = 132,
         esize: int = 4) -> bool:
    """Whether :func:`plan` finds a plan for these shapes in the form of
    ``esize`` (fewer resident clusters only change the rows, never whether
    a plan exists)."""
    try:
        plan(B, H, D, ndir, num_sms, esize=esize)
    except ValueError:
        return False
    return True


def max_clusters(dev, cluster: int) -> int:
    """How many clusters of ``cluster`` blocks the card ``dev`` keeps
    resident at once when every block asks for the most shared memory (as
    the pair does at config-2 width; a smaller block may fit more, which
    only makes the plan cautious)."""
    n = kernels.max_clusters("lstmx_fwd", dev, cluster, MAX_SMEM_BYTES)
    if n < 1:
        raise RuntimeError(f"no cluster of {cluster} blocks fits the card")
    return n


def card_plan(B: int, H: int, D: int, ndir: int, dev,
              esize: int = 4) -> XPlan:
    """:func:`plan` for the card ``dev``: its SM count and resident
    clusters."""
    return plan(B, H, D, ndir, _num_sms(dev),
                max_clusters(dev, cluster_units(H)[0]), esize)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _rows(d: int, B: int) -> slice:
    return slice(d * B, (d + 1) * B)


def _projection(xs, W, b, d: int, B: int):
    """Direction d's ``zx = xs_d @ W_d + b_d`` [T, B, 4H], float32 (the
    exact products of bfloat16 operands summed in float32 in the bfloat16
    form)."""
    return mm_f32(xs[:, _rows(d, B)], W[d]) + b[d]


def lstmx_forward_reference(xs, W, b, U, h0, c0, mask=None, *,
                            save_c: bool = False):
    """The forward of ``_lstm_fwdx_kernel`` / ``_bi_fwdx_kernel``: per
    direction ``zx = xs_d @ W_d + b_d``, then the steps ``z = zx_t + h @
    U_d``, the gates and the mask blend. In the bfloat16 form (xs, W and U
    bfloat16) zx stays float32 and h is rounded to bfloat16 at the product.
    Returns ``(ys, hT, cT)``, plus ``cs`` with ``save_c``."""
    ND = W.shape[0]
    B = xs.shape[1] // ND
    outs = []
    for d in range(ND):
        r = _rows(d, B)
        m = None if mask is None else mask[:, r]
        outs.append(lstm_forward_reference(
            _projection(xs, W, b, d, B), U[d], h0[r], c0[r], m,
            save_residuals=save_c))
    ys = torch.cat([o[0] for o in outs], dim=1)
    hT = torch.cat([o[1] for o in outs], dim=0)
    cT = torch.cat([o[2] for o in outs], dim=0)
    if save_c:
        return ys, hT, cT, torch.cat([o[4] for o in outs], dim=1)
    return ys, hT, cT


def rebuild_z(xs, ys, h0, W, b, U):
    """The backward's pre-activations [T, ND*B, 4H], float32: per direction
    ``zx_t + h_prev_t @ U_d`` (h_prev = h0, then ys[:-1], rounded to U's
    dtype at the product), step by step with the operands and products of
    :func:`lstmx_forward_reference`, so z is the forward's to the bit."""
    ND = W.shape[0]
    B = xs.shape[1] // ND
    h_prev = torch.cat([h0[None], ys[:-1]], dim=0)
    parts = []
    for d in range(ND):
        zx = _projection(xs, W, b, d, B)
        hp = h_prev[:, _rows(d, B)].to(U.dtype)
        parts.append(torch.stack([zx[t] + mm_f32(hp[t], U[d])
                                  for t in range(xs.shape[0])]))
    return torch.cat(parts, dim=1)


def lstmx_backward_reference(xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT,
                             mask=None):
    """The backward of ``_lstm_bwdx_kernel`` / ``_bi_bwdx_kernel``: per
    direction, rebuild z (:func:`rebuild_z`) and run the reverse cotangent
    algebra. In the bfloat16 form dz is rounded to bfloat16 once, where it
    is formed, and dh is that dz times Uᵀ (bfloat16) summed in float32.
    Returns ``(dz [T, ND*B, 4H] in xs's dtype, dh0, dc0)``."""
    ND = W.shape[0]
    B = xs.shape[1] // ND
    z = rebuild_z(xs, ys, h0, W, b, U)
    c_prev = torch.cat([c0[None], cs[:-1]], dim=0)
    outs = []
    for d in range(ND):
        r = _rows(d, B)
        m = None if mask is None else mask[:, r]
        outs.append(lstm_backward_reference(z[:, r], c_prev[:, r], dys[:, r],
                                            U[d], dhT[r], dcT[r], m,
                                            dz_dtype=xs.dtype))
    return (torch.cat([o[0] for o in outs], dim=1),
            torch.cat([o[1] for o in outs], dim=0),
            torch.cat([o[2] for o in outs], dim=0))


# ---------------------------------------------------------------------------
# dispatch and the kernel launches
# ---------------------------------------------------------------------------


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


def _check(xs, W, b, U, carries, streams, mask):
    """The operands of either kernel: ``xs``, ``W`` and ``U`` in one form's
    dtype (float32 or bfloat16), ``b``, the [ND*B, H] ``carries`` and the
    [T, ND*B, H] ``streams`` (dicts by name) and the mask float32,
    contiguous, on xs's device. Returns (T, B, ND, D, H, the form's
    dtype); raises otherwise (``TypeError`` for a mixed call)."""
    T, B, ND, D, H = _shapes(xs, W, U)
    dev, sd = xs.device, stream_dtype("xs", xs)
    BS = ND * B
    kernels.check_operand("xs", xs, (T, BS, D), dev, sd)
    kernels.check_operand("W", W, (ND, D, 4 * H), dev, sd)
    kernels.check_operand("b", b, (ND, 4 * H), dev, F32)
    kernels.check_operand("U", U, (ND, H, 4 * H), dev, sd)
    for name, t in streams.items():
        kernels.check_operand(name, t, (T, BS, H), dev, F32)
    for name, t in carries.items():
        kernels.check_operand(name, t, (BS, H), dev, F32)
    if mask is not None:
        kernels.check_operand("mask", mask, (T, BS), dev, F32)
    return T, B, ND, D, H, sd


def lstmx_forward(xs, W, b, U, h0, c0, mask=None, *, save_c: bool = False,
                  xplan: XPlan | None = None):
    """Forward of the pair: returns ``(ys [T, ND*B, H], hT, cT)`` and, with
    ``save_c``, ``cs`` [T, ND*B, H]. CUDA tensors launch
    ``csrc/lstmx_fwd.cu`` in the form of xs's dtype with ``xplan`` (default
    :func:`card_plan`); CPU tensors run the plain version."""
    if xs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {xs.device}")
    *shape, sd = _check(xs, W, b, U, {"h0": h0, "c0": c0}, {}, mask)
    if xs.device.type == "cuda":
        return _launch_fwd(xs, W, b, U, h0, c0, mask, save_c, xplan, shape,
                           sd)
    _counts("fwd", W.shape[0], sd).bump("reference")
    return lstmx_forward_reference(xs, W, b, U, h0, c0, mask, save_c=save_c)


def lstmx_backward(xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask=None, *,
                   xplan: XPlan | None = None):
    """Backward of the pair from the forward's ``ys`` and ``cs``: returns
    ``(dz [T, ND*B, 4H] in xs's dtype, dh0, dc0)``. CUDA tensors launch
    ``csrc/lstmx_bwd.cu`` in the form of xs's dtype with ``xplan`` (default
    :func:`card_plan`); CPU tensors run the plain version."""
    if xs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {xs.device}")
    *shape, sd = _check(xs, W, b, U,
                        {"h0": h0, "c0": c0, "dhT": dhT, "dcT": dcT},
                        {"ys": ys, "cs": cs, "dys": dys}, mask)
    if xs.device.type == "cuda":
        return _launch_bwd(xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask,
                           xplan, shape, sd)
    _counts("bwd", W.shape[0], sd).bump("reference")
    return lstmx_backward_reference(xs, ys, h0, cs, c0, dys, W, b, U,
                                    dhT, dcT, mask)


_p, _i = ctypes.c_void_p, ctypes.c_int
# csrc/lstmx_fwd.cu::lstmx_fwd_launch (and lstmx_fwd_bf16_launch): 13
# pointers (the last two the zx scratch and its ready counts), T, B, ND, D,
# H and the eight plan ints, the projection's stream and the chain's;
# lstmx_bwd_launch (and _bf16_launch): 18 pointers (the last two the factor
# scratch and its ready counts), the five shape ints and nine plan ints,
# the rebuild's stream and the chain's
_FWD_ARGTYPES = [_p] * 13 + [_i] * 13 + [_p] * 2
_BWD_ARGTYPES = [_p] * 18 + [_i] * 14 + [_p] * 2


def _launch_fwd(xs, W, b, U, h0, c0, mask, save_c, xplan, shape, sd):
    dev = xs.device
    T, B, ND, D, H = shape
    BS = ND * B
    pl = xplan or card_plan(B, H, D, ND, dev, esize_of(sd))
    kp = pl.fwd
    ys = torch.empty((T, BS, H), dtype=torch.float32, device=dev)
    hT = torch.empty((BS, H), dtype=torch.float32, device=dev)
    cT = torch.empty((BS, H), dtype=torch.float32, device=dev)
    cs = (torch.empty((T, BS, H), dtype=torch.float32, device=dev)
          if save_c else None)
    # the projection stays float32 in both forms
    zx = torch.empty(zx_floats(T, H, ND, pl), dtype=torch.float32,
                     device=dev)
    ready = torch.zeros(-(-T // kp.chunk) * ND * kp.groups,
                        dtype=torch.int32, device=dev)
    launch = kernels.launcher("lstmx_fwd", _FWD_ARGTYPES, entry(sd))
    with torch.cuda.device(dev):
        cur = torch.cuda.current_stream(dev)
        # the projection beside the chain when the chain leaves it SMs (the
        # chain's blocks wait for the chunks they need); else first
        side = None
        if projection_sms(pl, ND, _num_sms(dev)) >= REBUILD_MIN_SMS:
            side = _side_stream(dev)
            side.wait_stream(cur)
        rc = launch(
            xs.data_ptr(), W.data_ptr(), b.data_ptr(), U.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), _ptr(mask), ys.data_ptr(),
            hT.data_ptr(), cT.data_ptr(), _ptr(cs), zx.data_ptr(),
            ready.data_ptr(), T, B, ND, D, H, pl.cluster, pl.units, kp.rows,
            kp.rows4, kp.groups, pl.zks, kp.chunk,
            0 if kp.u_in_regs else 1 if kp.u_in_smem else 2,
            (side or cur).cuda_stream, cur.cuda_stream)
        if side is not None:
            cur.wait_stream(side)
    if rc != 0:
        raise RuntimeError(f"lstmx_fwd kernel launch failed: CUDA error {rc} "
                           f"(T={T} B={B} ND={ND} D={D} H={H}, {sd}, {pl})")
    _counts("fwd", ND, sd).bump("kernel")
    return (ys, hT, cT, cs) if save_c else (ys, hT, cT)


_side_streams: dict[int, torch.cuda.Stream] = {}


def _side_stream(dev) -> torch.cuda.Stream:
    """The side stream of the forward's projection and the backward's z
    rebuild on card ``dev``."""
    key = dev.index or 0
    s = _side_streams.get(key)
    if s is None:
        s = _side_streams[key] = torch.cuda.Stream(dev)
    return s


def _launch_bwd(xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask, xplan,
                shape, sd):
    dev = xs.device
    T, B, ND, D, H = shape
    BS = ND * B
    pl = xplan or card_plan(B, H, D, ND, dev, esize_of(sd))
    kp = pl.bwd
    ut = U.transpose(1, 2).contiguous()  # [ND, 4H, H]
    dz = torch.empty((T, BS, 4 * H), dtype=sd, device=dev)
    dh0 = torch.empty((BS, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((BS, H), dtype=torch.float32, device=dev)
    fac = torch.empty(factor_floats(T, ND, pl), dtype=torch.float32,
                      device=dev)
    ready = torch.zeros(-(-T // kp.chunk) * ND * kp.groups,
                        dtype=torch.int32, device=dev)
    launch = kernels.launcher("lstmx_bwd", _BWD_ARGTYPES, entry(sd))
    with torch.cuda.device(dev):
        cur = torch.cuda.current_stream(dev)
        # the rebuild beside the chain when the chain leaves it SMs (its
        # blocks wait for the chunks they need); else one after the other
        side = None
        if pl.cluster * kp.groups * ND <= _num_sms(dev) - REBUILD_MIN_SMS:
            side = _side_stream(dev)
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
                           f"(T={T} B={B} ND={ND} D={D} H={H}, {sd}, {pl})")
    _counts("bwd", ND, sd).bump("kernel")
    return dz, dh0, dc0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class LSTMXRecurrence(torch.autograd.Function):
    """``(xs [T, ND*B, D], W [ND, D, 4H], b [ND, 4H], U [ND, H, 4H], h0,
    c0, mask [T, ND*B] or None, dtype) -> (ys, hT, cT)`` through the
    residentx pair in ``dtype``'s form. xs, W and U come in float32 and are
    cast to ``dtype`` inside, so their gradients leave in float32 (as JAX
    casts each gradient to its operand's dtype). Saves xs, ys and cs; no
    gradient flows to the mask. dW, dU and dxs are products over T·B from
    the stream dtype's operands with float32 sums (``_pallas_backward``,
    ``_bi_backward``), db the float32 sum of dz."""

    @staticmethod
    def forward(ctx, xs, W, b, U, h0, c0, mask, dtype):
        xs, W, U = xs.to(dtype), W.to(dtype), U.to(dtype)
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
        h_prev = torch.cat([h0[None], ys[:-1]], dim=0).to(dz.dtype)
        dW, db, dU, dxs = [], [], [], []
        for d in range(ND):  # T·B contractions outside the kernel
            r = _rows(d, B)
            dz_d = dz[:, r].reshape(T * B, G)
            dW.append(mm_f32(xs[:, r].reshape(T * B, D).T, dz_d))
            dU.append(mm_f32(h_prev[:, r].reshape(T * B, H).T, dz_d))
            db.append(dz_d.float().sum(dim=0))
            dxs.append(mm_f32(dz_d, W[d].T).reshape(T, B, D))
        return (torch.cat(dxs, dim=1), torch.stack(dW), torch.stack(db),
                torch.stack(dU), dh0, dc0, None, None)


def lstmx_recurrence(xs, W, b, U, h0, c0, mask=None, dtype=F32):
    """The pair in ``dtype``'s form (float32 operands, cast inside) with the
    fused backward when autograd needs it; the forward alone, without the
    cs writes, otherwise (eval)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, W, b, U, h0, c0)):
        return LSTMXRecurrence.apply(xs, W, b, U, h0, c0, mask, dtype)
    return lstmx_forward(xs.to(dtype), W.to(dtype), b, U.to(dtype), h0, c0,
                         mask)


def cuda_lstmx_scan(params: LSTMParams, xs: torch.Tensor, carry=None, *,
                    mask: torch.Tensor | None = None, reverse: bool = False,
                    compute_dtype=None):
    """One LSTM layer over ``xs`` [B, T, D] through the single-direction
    residentx pair, with ``lstm_scan``'s contract (``carry`` (h, c) or
    None; ``mask`` bool [B, T]; ``reverse``, a flip outside the Function;
    ``compute_dtype``, whose bfloat16 takes the kernels' bfloat16 forms).
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
        fused.recurrent[None], h0, c0, m, resolve_dtype(compute_dtype))
    ys = ys.transpose(0, 1)
    if reverse:
        ys = torch.flip(ys, dims=(1,))
    return (hT, cT), ys
