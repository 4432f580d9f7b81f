"""The LSTM recurrence on the card: hand-written CUDA kernels for the forward
and the fused backward, their plain PyTorch versions, and the autograd
Function that joins them.

Counterpart of ``lstm_tensorspark_tpu/ops/pallas_lstm.py`` on its
"resident" path: ``csrc/lstm_fwd.cu`` replaces ``_lstm_kernel`` and
``csrc/lstm_bwd.cu`` replaces ``_lstm_bwd_kernel``.

- :func:`lstm_forward` / :func:`lstm_backward` are the dispatch: a CUDA
  tensor launches the kernel on the current stream or raises (there is no
  fallback); a CPU tensor runs :func:`lstm_forward_reference` /
  :func:`lstm_backward_reference`, the same functions in plain PyTorch.
- :class:`LSTMRecurrence` is the autograd Function over the recurrence
  alone, ``(xproj [T,B,4H], U [H,4H], h0, c0, mask) -> (ys, hT, cT)``.
  The input projection ``xs @ W + b`` is one matmul outside it (as in
  ``_pallas_forward``), so autograd gives dW, db and dxs; its backward
  returns dxproj = dz and contracts ``dU = h_prev^T dz`` in one matmul over
  T·B (as ``_pallas_backward`` does).
- :func:`lstm_recurrence` runs the Function when a gradient is needed and
  otherwise the forward without residual writes (the ``_scan_core`` /
  ``_scan_core_fwd`` split of the JAX package). The pieces it is built
  from (:func:`recurrence_forward`, :func:`recurrence_backward`,
  :func:`run_recurrence`) serve the tiled pair too
  (``ops/cuda_lstm_tiled.py``), which keeps this contract.
- :func:`cuda_lstm_scan` is the layer-level entry with ``lstm_scan``'s
  signature (mask and reverse; reverse is a flip outside the Function).
- :data:`fwd_counts` / :data:`bwd_counts` count kernel launches and plain
  runs, so a run can show its recurrence went through the kernels.
- :func:`plan` cuts a call (testable on the CPU); :func:`card_plan` hands
  it a card's SMs and, for the backward, the card's resident clusters.
- :func:`lstm_backward_factored` is the plain backward in the kernel's
  order of the algebra (the tests hold it against the plain version and
  the JAX pair).

Layouts are time-major inside (``[T, B, ·]``), gate order i, f, g, o. The
mask here is float32 ``[T, B]`` (1 = step, 0 = frozen carry). Each kernel
has two forms, chosen by the dtype of xproj (the forward) or z (the
backward): float32, and bfloat16 (JAX's Pallas route under bf16 compute,
``pallas_lstm._residual_dtype``), where xproj, z, dz and U are bfloat16,
h is rounded to bfloat16 at the product (dz is rounded once, at its store,
and dh formed from the rounded dz), every product accumulates in float32,
and ys, cs, the carries, dys and the mask stay float32. Their launches
count apart (:data:`fwd_bf16_counts`, :data:`bwd_bf16_counts`). A mixed
call raises ``TypeError``, but for one: the forward's third form, a float32
xproj with a bfloat16 U and no residuals (:data:`fwd_bf16u_counts`), the
rounding of JAX's plain XLA scan under bf16 compute, which JAX's serve
prefill runs (``cuda_lstm_scan(..., plain_rounding=True)``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from .lstm_cell import LSTMParams, fuse_params, mm_f32, resolve_dtype

THREADS = 256  # csrc/lstm_*.cu THREADS
MAX_CLUSTER = 8  # portable cluster size (csrc MAX_CLUSTER)
MAX_SMEM_BYTES = 232448  # 227 KB per block (csrc MAX_SMEM_BYTES)
UNITS_PER_BLOCK = 32  # hidden units a block aims to own
MIN_SPLIT = 32  # fewest terms of a split sum

fwd_counts = kernels.LaunchCounts("lstm_fwd")
bwd_counts = kernels.LaunchCounts("lstm_bwd")
# the bfloat16 forms of the same sources
fwd_bf16_counts = kernels.LaunchCounts("lstm_fwd_bf16")
bwd_bf16_counts = kernels.LaunchCounts("lstm_bwd_bf16")
# the forward's plain-rounding form: xproj float32, U bfloat16
fwd_bf16u_counts = kernels.LaunchCounts("lstm_fwd_bf16u")
STREAM_DTYPES = (torch.float32, torch.bfloat16)
F32 = torch.float32


def stream_dtype(name: str, t) -> torch.dtype:
    """The form a kernel call takes, by the dtype of its stream ``t``
    (xproj or z): float32 or bfloat16; ``TypeError`` for another."""
    if t.dtype not in STREAM_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    return t.dtype


def esize_of(dtype: torch.dtype) -> int:
    """Bytes of one element of U and the streams in ``dtype``'s form."""
    return 2 if dtype == torch.bfloat16 else 4


def counts_of(dtype, f32_counts, bf16_counts):
    """The launch counter of ``dtype``'s form."""
    return bf16_counts if dtype == torch.bfloat16 else f32_counts


def forward_entry(xproj, sd: torch.dtype) -> str:
    """The C entry of a forward call's form: the form of ``sd`` (U's
    dtype, :func:`check_forward`), or ``"bf16u_launch"`` for a float32
    xproj with a bfloat16 U."""
    return "bf16u_launch" if xproj.dtype != sd else entry(sd)


class Plan(NamedTuple):
    """How a kernel call is cut: clusters of ``cluster`` blocks, each block
    owning ``units`` hidden units, each cluster ``rows`` batch rows
    (``rows4`` rounded up to 4), the product's sum split ``ksplit`` ways
    (the lanes that share a sum: the forward's a unit's, the backward's a
    warp's, over a unit quad), ``smem_w`` whether the block's slice of U
    (the backward: of Uᵀ) sits in shared memory and ``u_regs`` whether the
    lanes keep their slices in registers (neither: read through L2).
    ``smem_bytes`` is what one block asks for; ``slots`` the (unit quad,
    row quad) slots a warp of the backward takes."""

    cluster: int
    units: int
    rows: int
    rows4: int
    ksplit: int
    smem_w: bool
    smem_bytes: int
    u_regs: bool = False
    slots: int = 1


# rows of U a forward lane keeps in registers (csrc/lstm_fwd.cu KREG)
KREG = 16
# csrc/lstm_bwd.cu: its warps; the terms of each of a unit quad's four
# units a lane keeps in registers; the most slots a warp takes
WARPS = THREADS // 32
UT_TERMS = 16
MAX_SLOTS = 8


def _lanes(items: int, cap: int) -> int:
    """The largest power of two that is at most 32, at most ``cap`` and at
    most THREADS // items: the lanes that share one item's sum."""
    n = 1
    while n * 2 <= min(32, cap, THREADS // items):
        n *= 2
    return n


def _fwd_plan(B: int, H: int, cs: int, upc: int, clusters: int,
              esize: int = 4) -> Plan:
    """The forward's plan (csrc/lstm_fwd.cu): a group of lanes owns one unit
    and four rows, so a block takes at most THREADS // upc row quads. The
    slice of U in shared memory takes ``esize`` bytes an element (2 in the
    bfloat16 form)."""
    rows = -(-B // clusters)
    rows = min(B, -(-rows // 4) * 4, 4 * max(1, THREADS // upc))
    rows4 = -(-rows // 4) * 4
    ks = _lanes(upc * (rows4 // 4), 32)
    base = 2 * H * rows4 + 4  # h double buffer, two mbarriers
    if 4 * base > MAX_SMEM_BYTES:
        raise ValueError(
            f"lstm fwd kernel: B={B} H={H} needs {4 * base} bytes of "
            f"shared memory per block (> {MAX_SMEM_BYTES})")
    u_regs = -(-H // ks) <= KREG
    w = esize * 4 * H * upc
    smem_w = not u_regs and 4 * base + w <= MAX_SMEM_BYTES
    return Plan(cs, upc, rows, rows4, ks, smem_w,
                4 * base + (w if smem_w else 0), u_regs)


def bwd_slots(units: int, rows4: int) -> int:
    """The (unit quad, row quad) slots a warp of the backward takes
    (``csrc/lstm_bwd.cu``): eight warps over the block's unit quads, the
    warps of a quad (when it has more than one) dealing out the row
    quads."""
    uq = -(-units // 4)
    per_quad = max(1, WARPS // uq)
    return -(-uq // WARPS) * -(-(rows4 // 4) // per_quad)


def _bwd_smem(H: int, units: int, rows4: int, where: str,
              esize: int = 4) -> int:
    """Bytes of the backward's layout (``csrc/lstm_bwd.cu``
    bwd_smem_bytes): dz double-buffered over 4H columns padded to the
    lanes' terms (float32), two mbarriers, and Uᵀ's slice, ``esize``
    bytes an element, when it sits in shared memory."""
    G = 4 * H
    gp = 32 * UT_TERMS if where == "regs" else -(-G // 128) * 128
    n = 4 * (2 * rows4 * gp + 4)
    if where == "smem":
        n += esize * -(-units // 4) * gp * 4
    return n


def _bwd_plan(B: int, H: int, cs: int, upc: int, clusters: int,
              esize: int = 4) -> Plan:
    """The backward's plan (csrc/lstm_bwd.cu): a warp a unit quad and row
    quad, Uᵀ's slice in the lanes' registers when a lane's 16 terms of four
    units cover 4H and a warp's slots share one unit quad (at most four of
    them), else in shared memory when it fits, else read through L2. The
    rows are cut down when a warp would take more than ``MAX_SLOTS``
    slots; a shape whose dz buffers then do not fit a block raises."""
    rows = -(-B // clusters)
    rows = min(B, -(-rows // 4) * 4)
    rows4 = -(-rows // 4) * 4
    uq = -(-upc // 4)
    nuq = -(-uq // WARPS)
    per_quad = max(1, WARPS // uq)
    rq = min(rows4 // 4, (MAX_SLOTS // nuq) * per_quad)
    need = _bwd_smem(H, upc, 4 * max(rq, 1), "l2")
    if rq < 1 or need > MAX_SMEM_BYTES:
        raise ValueError(
            f"lstm bwd kernel: B={B} H={H} needs {need} bytes of shared "
            f"memory per block (> {MAX_SMEM_BYTES}) or more than "
            f"{MAX_SLOTS} slots a warp")
    if 4 * rq < rows4:
        rows = rows4 = 4 * rq
    slots = bwd_slots(upc, rows4)
    where = "l2"
    if (nuq == 1 and 4 * H <= 32 * UT_TERMS and slots <= 4
            and _bwd_smem(H, upc, rows4, "regs") <= MAX_SMEM_BYTES):
        where = "regs"
    elif _bwd_smem(H, upc, rows4, "smem", esize) <= MAX_SMEM_BYTES:
        where = "smem"
    return Plan(cs, upc, rows, rows4, 32, where == "smem",
                _bwd_smem(H, upc, rows4, where, esize), where == "regs",
                slots)


def plan(kind: str, B: int, H: int, num_sms: int = 132,
         max_clusters: int | None = None, esize: int = 4) -> Plan:
    """The launch plan of the ``"fwd"`` or ``"bwd"`` kernel for B rows of
    width H on a card with ``num_sms`` SMs; the backward's rows spread over
    at most ``max_clusters`` clusters (the card's resident clusters,
    :func:`card_plan`) when their buffers fit, else over every cluster the
    SMs hold (a second wave). ``esize`` is the bytes of an element of U:
    4, or 2 in the bfloat16 forms, whose slice of U in shared memory takes
    half the room. Mirrors the shared-memory layouts at the top of
    ``csrc/lstm_fwd.cu`` / ``csrc/lstm_bwd.cu``. Raises ``ValueError`` for
    a shape whose buffers do not fit a block."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"kind must be 'fwd' or 'bwd', got {kind!r}")
    if B < 1 or H < 1:
        raise ValueError(f"need B >= 1 and H >= 1, got B={B}, H={H}")
    cs = min(MAX_CLUSTER, -(-H // UNITS_PER_BLOCK))
    upc = -(-H // cs)
    cs = -(-H // upc)  # no block without units
    clusters = max(1, num_sms // cs)
    if kind == "fwd":
        return _fwd_plan(B, H, cs, upc, clusters, esize)
    if max_clusters is not None and max_clusters < clusters:
        try:  # rows for the resident clusters, when their buffers fit
            return _bwd_plan(B, H, cs, upc, max(1, max_clusters), esize)
        except ValueError:
            pass
    return _bwd_plan(B, H, cs, upc, clusters, esize)


def card_plan(kind: str, B: int, H: int, dev, esize: int = 4) -> Plan:
    """:func:`plan` for the card ``dev``: its SM count and, for the
    backward, the clusters it keeps resident at once (asked of the CUDA
    runtime once per card and cluster size)."""
    from .cuda_lstmx import max_clusters

    sms = _num_sms(dev)
    if kind == "fwd":
        return plan(kind, B, H, sms, esize=esize)
    cs = plan(kind, B, H, sms, esize=esize).cluster
    return plan(kind, B, H, sms, max_clusters(dev, cs), esize=esize)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _gates(z: torch.Tensor):
    zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
    return torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg), torch.sigmoid(zo)


def lstm_forward_reference(xproj, U, h0, c0, mask=None, *,
                           save_residuals: bool = False):
    """The forward recurrence, step for step the algebra of the JAX
    ``_lstm_kernel``. Returns ``(ys, hT, cT)``, plus ``(z, cs)`` with
    ``save_residuals``. In the bfloat16 form (xproj and U bfloat16) h is
    rounded at the product, which accumulates in float32, the gates take
    the float32 z and the stored z is rounded once."""
    h, c = h0, c0
    ys, zs, cs = [], [], []
    for t in range(xproj.shape[0]):
        z = xproj[t].float() + mm_f32(h.to(U.dtype), U)
        i, f, g, o = _gates(z)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if mask is not None:
            m = mask[t][:, None]
            c = m * c_new + (1.0 - m) * c
            h = m * h_new + (1.0 - m) * h
        else:
            c, h = c_new, h_new
        ys.append(h)
        zs.append(z.to(xproj.dtype))
        cs.append(c)
    out = (torch.stack(ys), h, c)
    if save_residuals:
        out += (torch.stack(zs), torch.stack(cs))
    return out


def lstm_backward_reference(z, c_prev, dys, U, dhT, dcT, mask=None, *,
                            dz_dtype=None):
    """Reverse-time BPTT from the forward's residuals, step for step the
    algebra of the JAX ``_lstm_bwd_kernel``: ``z`` [T,B,4H], ``c_prev``
    [T,B,H] (c0, then cs[:-1]), ``dys`` [T,B,H]. Returns ``(dz, dh0,
    dc0)``, dz in ``dz_dtype`` (default z's). In the bfloat16 form (U and
    dz bfloat16; z bfloat16 too, except in the residentx pair's backward,
    whose rebuilt z is float32) the gates come from z, dz is rounded once,
    at its store, and dh is the rounded dz times Uᵀ accumulated in
    float32."""
    dh, dc = dhT, dcT
    dzs = [None] * z.shape[0]
    for t in range(z.shape[0] - 1, -1, -1):
        i, f, g, o = _gates(z[t].float())
        cp = c_prev[t]
        tc = torch.tanh(f * cp + i * g)
        dh_tot = dh + dys[t]
        dc_in = dc
        if mask is not None:
            m = mask[t][:, None]
            dh_eff, dc_eff = m * dh_tot, m * dc_in
        else:
            dh_eff, dc_eff = dh_tot, dc_in
        dc_new = dc_eff + dh_eff * o * (1.0 - tc * tc)
        do = dh_eff * tc * o * (1.0 - o)
        di = dc_new * g * i * (1.0 - i)
        df = dc_new * cp * f * (1.0 - f)
        dg = dc_new * i * (1.0 - g * g)
        dz = torch.cat([di, df, dg, do], dim=-1).to(dz_dtype or z.dtype)
        dzs[t] = dz
        dh = mm_f32(dz, U.T)
        dc = dc_new * f
        if mask is not None:
            dh = dh + (1.0 - m) * dh_tot
            dc = dc + (1.0 - m) * dc_in
    return torch.stack(dzs), dh, dc


def lstm_backward_factored(z, c_prev, dys, U, dhT, dcT, mask=None):
    """:func:`lstm_backward_reference` in ``csrc/lstm_bwd.cu``'s order: the
    algebra's factors of every step first (they depend on the residuals
    alone), then the reverse walk with one multiply a term (no mask: m =
    1). The kernel sums dz @ Uᵀ in another order still; this twin pins the
    re-association of the algebra."""
    i, f, g, o = _gates(z)
    tc = torch.tanh(f * c_prev + i * g)
    A = o * (1.0 - tc * tc)
    Bo = tc * o * (1.0 - o)
    Ci = g * i * (1.0 - i)
    Cf = c_prev * f * (1.0 - f)
    Cg = i * (1.0 - g * g)
    ms = torch.ones_like(dys[..., :1]) if mask is None else mask[..., None]
    dh, dc = dhT, dcT
    dzs = [None] * z.shape[0]
    for t in range(z.shape[0] - 1, -1, -1):
        m = ms[t]
        dh_tot = dh + dys[t]
        dh_eff = m * dh_tot
        dc_new = m * dc + dh_eff * A[t]
        dz = torch.cat([dc_new * Ci[t], dc_new * Cf[t], dc_new * Cg[t],
                        dh_eff * Bo[t]], dim=-1)
        dzs[t] = dz
        dh = dz @ U.T + (1.0 - m) * dh_tot
        dc = dc_new * f[t] + (1.0 - m) * dc
    return torch.stack(dzs), dh, dc


# ---------------------------------------------------------------------------
# dispatch and the kernel launches
# ---------------------------------------------------------------------------


def check_forward(xproj, U, h0, c0, mask):
    """The forward's operands: ``xproj`` [T>=1, B, 4H] and ``U`` [H, 4H] in
    one form's dtype (float32 or bfloat16; or xproj float32 with U
    bfloat16, the plain-rounding form), ``h0``, ``c0`` [B, H] and the mask
    [T, B] float32, contiguous, on one device. Returns (T, B, H, U's
    dtype); raises otherwise."""
    if xproj.dim() != 3 or xproj.shape[2] % 4 or xproj.shape[0] < 1:
        raise ValueError(f"xproj must be [T >= 1, B, 4H], got "
                         f"{tuple(xproj.shape)}")
    T, B, G = xproj.shape
    H = G // 4
    dev, sd = xproj.device, stream_dtype("xproj", xproj)
    kernels.check_operand("xproj", xproj, (T, B, G), dev, sd)
    if sd == F32 and U.dtype == torch.bfloat16:
        sd = torch.bfloat16  # the plain-rounding form
    kernels.check_operand("U", U, (H, G), dev, sd)
    kernels.check_operand("h0", h0, (B, H), dev, F32)
    kernels.check_operand("c0", c0, (B, H), dev, F32)
    _check_mask(mask, T, B, dev)
    return T, B, H, sd


def check_backward(z, c0, cs, dys, U, dhT, dcT, mask):
    """The backward's operands: ``z`` [T>=1, B, 4H] and ``U`` [H, 4H] in one
    form's dtype, the rest float32 (``c0``, ``dhT``, ``dcT`` [B, H];
    ``cs``, ``dys`` [T, B, H]; the mask [T, B]). Returns (T, B, H, the
    form's dtype); raises otherwise."""
    if z.dim() != 3 or z.shape[2] % 4 or z.shape[0] < 1:
        raise ValueError(f"z must be [T >= 1, B, 4H], got {tuple(z.shape)}")
    T, B, G = z.shape
    H = G // 4
    dev, sd = z.device, stream_dtype("z", z)
    kernels.check_operand("z", z, (T, B, G), dev, sd)
    kernels.check_operand("c0", c0, (B, H), dev, F32)
    kernels.check_operand("cs", cs, (T, B, H), dev, F32)
    kernels.check_operand("dys", dys, (T, B, H), dev, F32)
    kernels.check_operand("U", U, (H, G), dev, sd)
    kernels.check_operand("dhT", dhT, (B, H), dev, F32)
    kernels.check_operand("dcT", dcT, (B, H), dev, F32)
    _check_mask(mask, T, B, dev)
    return T, B, H, sd


def lstm_forward(xproj, U, h0, c0, mask=None, *, save_residuals: bool = False):
    """Forward recurrence: ``xproj`` [T,B,4H], ``U`` [H,4H], ``h0``/``c0``
    [B,H], ``mask`` [T,B] float32 or None. Returns ``(ys [T,B,H], hT,
    cT)`` and, with ``save_residuals``, ``z`` [T,B,4H] (in xproj's dtype)
    and ``cs`` [T,B,H]. CUDA tensors launch ``csrc/lstm_fwd.cu`` in the
    form of the operands' dtypes (:func:`forward_entry`); CPU tensors run
    the plain version."""
    if xproj.device.type == "cuda":
        return _launch_fwd(xproj, U, h0, c0, mask, save_residuals)
    if xproj.device.type != "cpu":
        raise ValueError(f"unsupported device {xproj.device}")
    *_, sd = check_forward(xproj, U, h0, c0, mask)
    fwd_form_counts(xproj, sd).bump("reference")
    return lstm_forward_reference(xproj, U, h0, c0, mask,
                                  save_residuals=save_residuals)


def fwd_form_counts(xproj, sd):
    """The launch counter of a resident forward call's form."""
    return {"launch": fwd_counts, "bf16_launch": fwd_bf16_counts,
            "bf16u_launch": fwd_bf16u_counts}[forward_entry(xproj, sd)]


def check_plain_rounding(xproj, sd, save_residuals: bool) -> None:
    """The plain-rounding form (float32 xproj, bfloat16 U) runs forward
    only: it writes no residuals."""
    if save_residuals and xproj.dtype != sd:
        raise ValueError("a float32 xproj with a bfloat16 U (the "
                         "plain-rounding form) saves no residuals")


def lstm_backward(z, c0, cs, dys, U, dhT, dcT, mask=None):
    """Fused BPTT from the forward's residuals ``z`` and ``cs`` (and
    ``c0``): returns ``(dz [T,B,4H] in z's dtype, dh0, dc0)``. CUDA tensors
    launch ``csrc/lstm_bwd.cu`` in the form of z's dtype; CPU tensors run
    the plain version."""
    if z.device.type == "cuda":
        return _launch_bwd(z, c0, cs, dys, U, dhT, dcT, mask)
    if z.device.type != "cpu":
        raise ValueError(f"unsupported device {z.device}")
    *_, sd = check_backward(z, c0, cs, dys, U, dhT, dcT, mask)
    counts_of(sd, bwd_counts, bwd_bf16_counts).bump("reference")
    c_prev = torch.cat([c0[None], cs[:-1]], dim=0)
    return lstm_backward_reference(z, c_prev, dys, U, dhT, dcT, mask)


_p, _i = ctypes.c_void_p, ctypes.c_int
# csrc/lstm_fwd.cu::lstm_fwd_launch (and lstm_fwd_bf16_launch): 10 tensor
# pointers, T, B, H and the six plan ints, the stream;
# csrc/lstm_bwd.cu::lstm_bwd_launch (and _bf16_launch) the same with 11
# pointers
_FWD_ARGTYPES = [_p] * 10 + [_i] * 9 + [_p]
_BWD_ARGTYPES = [_p] * 11 + [_i] * 9 + [_p]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _num_sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_mask(mask, T, B, dev):
    if mask is not None:
        kernels.check_operand("mask", mask, (T, B), dev, F32)


def entry(dtype) -> str:
    """The C entry point of a source's form for ``dtype``."""
    return "bf16_launch" if dtype == torch.bfloat16 else "launch"


def _launch_fwd(xproj, U, h0, c0, mask, save_residuals):
    dev = xproj.device
    T, B, H, sd = check_forward(xproj, U, h0, c0, mask)
    check_plain_rounding(xproj, sd, save_residuals)
    G = 4 * H
    pl = plan("fwd", B, H, _num_sms(dev), esize=esize_of(sd))
    ys = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    hT = torch.empty((B, H), dtype=torch.float32, device=dev)
    cT = torch.empty((B, H), dtype=torch.float32, device=dev)
    z = cs = None
    if save_residuals:
        z = torch.empty((T, B, G), dtype=sd, device=dev)
        cs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    launch = kernels.launcher("lstm_fwd", _FWD_ARGTYPES,
                              forward_entry(xproj, sd))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            xproj.data_ptr(), U.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            _ptr(mask), ys.data_ptr(), hT.data_ptr(), cT.data_ptr(), _ptr(z),
            _ptr(cs), T, B, H, pl.cluster, pl.units, pl.rows, pl.rows4,
            pl.ksplit, 0 if pl.u_regs else 1 if pl.smem_w else 2, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_fwd kernel launch failed: CUDA error {rc} "
                           f"(T={T} B={B} H={H}, {sd}, {pl})")
    fwd_form_counts(xproj, sd).bump("kernel")
    return (ys, hT, cT, z, cs) if save_residuals else (ys, hT, cT)


def _launch_bwd(z, c0, cs, dys, U, dhT, dcT, mask):
    dev = z.device
    T, B, H, sd = check_backward(z, c0, cs, dys, U, dhT, dcT, mask)
    G = 4 * H
    pl = card_plan("bwd", B, H, dev, esize=esize_of(sd))
    dz = torch.empty((T, B, G), dtype=sd, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    launch = kernels.launcher("lstm_bwd", _BWD_ARGTYPES, entry(sd))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            z.data_ptr(), dys.data_ptr(), cs.data_ptr(), c0.data_ptr(),
            _ptr(mask), U.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
            dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), T, B, H,
            pl.cluster, pl.units, pl.rows, pl.rows4, pl.slots,
            0 if pl.u_regs else 1 if pl.smem_w else 2, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_bwd kernel launch failed: CUDA error {rc} "
                           f"(T={T} B={B} H={H}, {sd}, {pl})")
    counts_of(sd, bwd_counts, bwd_bf16_counts).bump("kernel")
    return dz, dh0, dc0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def recurrence_forward(ctx, forward, xproj, U, h0, c0, mask):
    """The Function's forward over a kernel pair with this module's
    contract: ``forward`` runs with residuals, which are saved for
    :func:`recurrence_backward`. ``U`` comes in its parameter's float32
    and goes to the kernel in xproj's dtype (its gradient leaves in
    float32, as JAX casts each gradient to its parameter)."""
    Us = U.to(xproj.dtype)
    ys, hT, cT, z, cs = forward(xproj, Us, h0, c0, mask, save_residuals=True)
    ctx.save_for_backward(Us, h0, c0, ys, z, cs, mask)
    return ys, hT, cT


def recurrence_backward(ctx, backward, dys, dhT, dcT):
    """The Function's backward: ``backward`` gives dz (= dxproj), dh0 and
    dc0; ``dU = h_prev^T dz`` is one matmul over T·B (h_prev rounded to
    dz's dtype, accumulated in float32: JAX ``_pallas_backward``)."""
    Us, h0, c0, ys, z, cs, mask = ctx.saved_tensors
    dz, dh0, dc0 = backward(z, c0, cs, dys.contiguous(), Us,
                            dhT.contiguous(), dcT.contiguous(), mask)
    T, B, G = dz.shape
    H = G // 4
    h_prev = torch.cat([h0[None], ys[:-1]], dim=0)
    dU = mm_f32(h_prev.reshape(T * B, H).to(dz.dtype).T, dz.reshape(T * B, G))
    return dz, dU, dh0, dc0, None


class LSTMRecurrence(torch.autograd.Function):
    """``(xproj [T,B,4H], U [H,4H], h0, c0, mask [T,B] or None) -> (ys
    [T,B,H], hT, cT)`` with the fused backward. Saves z and cs (the
    forward's residuals) for the backward; no gradient flows to the
    mask. xproj's dtype picks the kernels' form; U is float32 (cast to
    that form inside)."""

    @staticmethod
    def forward(ctx, xproj, U, h0, c0, mask):
        return recurrence_forward(ctx, lstm_forward, xproj, U, h0, c0, mask)

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        return recurrence_backward(ctx, lstm_backward, dys, dhT, dcT)


def run_recurrence(function, forward, xproj, U, h0, c0, mask=None):
    """``function`` (an autograd Function over a kernel pair) when autograd
    needs it; ``forward`` alone, without residual writes, otherwise
    (``torch.no_grad``, eval, prefill). ``U`` is float32; the kernels take
    it in xproj's dtype."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xproj, U, h0, c0)):
        return function.apply(xproj, U, h0, c0, mask)
    # a bfloat16 U stays bfloat16 (with a float32 xproj: the plain-rounding
    # form)
    Uf = U if U.dtype == torch.bfloat16 else U.to(xproj.dtype)
    return forward(xproj, Uf, h0, c0, mask)


class BF16Projection(torch.autograd.Function):
    """``(xs [..., D], W [D, 4H], b [4H]) -> xproj`` in bfloat16 as JAX's
    Pallas route forms it (``_pallas_forward``): ``xs·W`` from bfloat16
    operands accumulated in float32, plus the float32 bias, rounded once.
    Its backward (``_pallas_backward``) takes dxproj = dz (bfloat16):
    ``dW = xsᵀ·dz`` and ``dxs = dz·Wᵀ`` from bfloat16 operands accumulated
    in float32, ``db`` the float32 sum of dz; each gradient float32."""

    @staticmethod
    def forward(ctx, xs, W, b):
        xb, Wb = xs.to(torch.bfloat16), W.to(torch.bfloat16)
        ctx.save_for_backward(xb, Wb)
        return (mm_f32(xb, Wb) + b).to(torch.bfloat16)

    @staticmethod
    def backward(ctx, dz):
        xb, Wb = ctx.saved_tensors
        D, G = Wb.shape
        dW = mm_f32(xb.reshape(-1, D).T, dz.reshape(-1, G))
        db = dz.float().sum(dim=tuple(range(dz.dim() - 1)))
        return mm_f32(dz, Wb.T), dW, db


def project(xs, fused, compute_dtype=None):
    """The recurrence's input ``xproj = xs @ W + b`` (xs [..., D], fused
    float32 params): float32 by autograd, or bfloat16 through
    :class:`BF16Projection` when ``compute_dtype`` is bfloat16."""
    if resolve_dtype(compute_dtype) == torch.bfloat16:
        return BF16Projection.apply(xs, fused.kernel, fused.bias)
    return torch.matmul(xs, fused.kernel) + fused.bias


def lstm_recurrence(xproj, U, h0, c0, mask=None):
    """The recurrence through the resident pair (:func:`run_recurrence`)."""
    return run_recurrence(LSTMRecurrence, lstm_forward, xproj, U, h0, c0,
                          mask)


def cuda_lstm_scan(params: LSTMParams, xs: torch.Tensor, carry=None, *,
                   mask: torch.Tensor | None = None, reverse: bool = False,
                   recurrence=lstm_recurrence, compute_dtype=None,
                   plain_rounding: bool = False):
    """One LSTM layer over ``xs`` [B, T, D] through ``recurrence`` (the
    resident pair's :func:`lstm_recurrence` unless told otherwise): the
    same contract as ``ops.scan.lstm_scan`` (``carry`` (h, c) each [B, H]
    or None; ``mask`` bool [B, T]; ``reverse``; ``compute_dtype``, whose
    bfloat16 takes the kernels' bfloat16 forms). ``plain_rounding`` under
    bfloat16 rounds as JAX's plain XLA scan does (the projection float32
    from bfloat16 operands, U bfloat16: the forward's plain-rounding form),
    forward only, where the kernel route stores xproj in bfloat16. Returns
    ``((hT, cT), ys [B, T, H])``."""
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
    U = fused.recurrent
    if plain_rounding and resolve_dtype(compute_dtype) == torch.bfloat16:
        if torch.is_grad_enabled() and any(t.requires_grad for t in params):
            raise ValueError("plain_rounding is a forward-only form (no "
                             "gradient flows through it)")
        bf = torch.bfloat16
        xproj = (mm_f32(xs.transpose(0, 1).to(bf), fused.kernel.to(bf))
                 + fused.bias)
        U = U.to(bf)
    else:
        xproj = project(xs.transpose(0, 1), fused, compute_dtype)
    m = None if mask is None else mask.transpose(0, 1).to(torch.float32).contiguous()
    ys, hT, cT = recurrence(xproj.contiguous(), U, h0, c0, m)
    ys = ys.transpose(0, 1)
    if reverse:
        ys = torch.flip(ys, dims=(1,))
    return (hT, cT), ys
