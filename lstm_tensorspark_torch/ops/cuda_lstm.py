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

Layouts are time-major inside (``[T, B, ·]``), float32, gate order i, f, g,
o. The mask here is float32 ``[T, B]`` (1 = step, 0 = frozen carry).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from .lstm_cell import LSTMParams, fuse_params

THREADS = 256  # csrc/lstm_*.cu THREADS
MAX_CLUSTER = 8  # portable cluster size (csrc MAX_CLUSTER)
MAX_SMEM_BYTES = 232448  # 227 KB per block (csrc MAX_SMEM_BYTES)
UNITS_PER_BLOCK = 32  # hidden units a block aims to own
MIN_SPLIT = 32  # fewest terms of a split sum

fwd_counts = kernels.LaunchCounts()
bwd_counts = kernels.LaunchCounts()


class Plan(NamedTuple):
    """How a kernel call is cut: clusters of ``cluster`` blocks, each block
    owning ``units`` hidden units, each cluster ``rows`` batch rows
    (``rows4`` rounded up to 4), the product's sum split ``ksplit`` ways,
    and ``smem_w`` whether the block's slice of U sits in shared memory.
    ``smem_bytes`` is what one block asks for."""

    cluster: int
    units: int
    rows: int
    rows4: int
    ksplit: int
    smem_w: bool
    smem_bytes: int


def plan(kind: str, B: int, H: int, num_sms: int = 132) -> Plan:
    """The launch plan of the ``"fwd"`` or ``"bwd"`` kernel for B rows of
    width H on a card with ``num_sms`` SMs. Mirrors the shared-memory
    layouts at the top of ``csrc/lstm_fwd.cu`` / ``csrc/lstm_bwd.cu``.
    Raises ``ValueError`` for a shape whose buffers do not fit a block."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"kind must be 'fwd' or 'bwd', got {kind!r}")
    if B < 1 or H < 1:
        raise ValueError(f"need B >= 1 and H >= 1, got B={B}, H={H}")
    cs = min(MAX_CLUSTER, -(-H // UNITS_PER_BLOCK))
    upc = -(-H // cs)
    cs = -(-H // upc)  # no block without units
    clusters = max(1, num_sms // cs)
    rows = -(-B // clusters)
    rows = min(B, -(-rows // 4) * 4)
    rows4 = -(-rows // 4) * 4
    G = 4 * H
    if kind == "fwd":
        K, ncols = H, 4 * upc
        base = 2 * H * rows4 + rows4 * ncols + rows4 * upc
        w = H * ncols
    else:
        K, ncols = G, upc
        base = 2 * G * rows4 + 3 * rows4 * upc
        w = G * upc
    items = ncols * (rows4 // 4)
    ks = max(1, min(THREADS // items, K // MIN_SPLIT))
    if ks > 1:
        base += ks * rows4 * ncols
    if 4 * base > MAX_SMEM_BYTES:
        raise ValueError(
            f"lstm {kind} kernel: B={B} H={H} needs {4 * base} bytes of "
            f"shared memory per block (> {MAX_SMEM_BYTES})")
    smem_w = 4 * (base + w) <= MAX_SMEM_BYTES
    return Plan(cs, upc, rows, rows4, ks, smem_w,
                4 * (base + (w if smem_w else 0)))


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
    ``save_residuals``."""
    h, c = h0, c0
    ys, zs, cs = [], [], []
    for t in range(xproj.shape[0]):
        z = xproj[t] + h @ U
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
        zs.append(z)
        cs.append(c)
    out = (torch.stack(ys), h, c)
    if save_residuals:
        out += (torch.stack(zs), torch.stack(cs))
    return out


def lstm_backward_reference(z, c_prev, dys, U, dhT, dcT, mask=None):
    """Reverse-time BPTT from the forward's residuals, step for step the
    algebra of the JAX ``_lstm_bwd_kernel``: ``z`` [T,B,4H], ``c_prev``
    [T,B,H] (c0, then cs[:-1]), ``dys`` [T,B,H]. Returns ``(dz, dh0,
    dc0)``."""
    dh, dc = dhT, dcT
    dzs = [None] * z.shape[0]
    for t in range(z.shape[0] - 1, -1, -1):
        i, f, g, o = _gates(z[t])
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
        dz = torch.cat([di, df, dg, do], dim=-1)
        dzs[t] = dz
        dh = dz @ U.T
        dc = dc_new * f
        if mask is not None:
            dh = dh + (1.0 - m) * dh_tot
            dc = dc + (1.0 - m) * dc_in
    return torch.stack(dzs), dh, dc


# ---------------------------------------------------------------------------
# dispatch and the kernel launches
# ---------------------------------------------------------------------------


def lstm_forward(xproj, U, h0, c0, mask=None, *, save_residuals: bool = False):
    """Forward recurrence: ``xproj`` [T,B,4H], ``U`` [H,4H], ``h0``/``c0``
    [B,H], ``mask`` [T,B] float32 or None. Returns ``(ys [T,B,H], hT,
    cT)`` and, with ``save_residuals``, ``z`` [T,B,4H] and ``cs``
    [T,B,H]. CUDA tensors launch ``csrc/lstm_fwd.cu``; CPU tensors run the
    plain version."""
    if xproj.device.type == "cuda":
        return _launch_fwd(xproj, U, h0, c0, mask, save_residuals)
    if xproj.device.type == "cpu":
        fwd_counts.bump("reference")
        return lstm_forward_reference(xproj, U, h0, c0, mask,
                                      save_residuals=save_residuals)
    raise ValueError(f"unsupported device {xproj.device}")


def lstm_backward(z, c0, cs, dys, U, dhT, dcT, mask=None):
    """Fused BPTT from the forward's residuals ``z`` and ``cs`` (and
    ``c0``): returns ``(dz [T,B,4H], dh0, dc0)``. CUDA tensors launch
    ``csrc/lstm_bwd.cu``; CPU tensors run the plain version."""
    if z.device.type == "cuda":
        return _launch_bwd(z, c0, cs, dys, U, dhT, dcT, mask)
    if z.device.type == "cpu":
        bwd_counts.bump("reference")
        c_prev = torch.cat([c0[None], cs[:-1]], dim=0)
        return lstm_backward_reference(z, c_prev, dys, U, dhT, dcT, mask)
    raise ValueError(f"unsupported device {z.device}")


_p, _i = ctypes.c_void_p, ctypes.c_int
# csrc/lstm_fwd.cu::lstm_fwd_launch: 10 tensor pointers, T, B, H and the six
# plan ints, the stream; lstm_bwd_launch the same with 11 pointers
_FWD_ARGTYPES = [_p] * 10 + [_i] * 9 + [_p]
_BWD_ARGTYPES = [_p] * 11 + [_i] * 9 + [_p]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _num_sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_mask(mask, T, B, dev):
    if mask is not None:
        kernels.check_f32("mask", mask, (T, B), dev)


def _launch_fwd(xproj, U, h0, c0, mask, save_residuals):
    dev = xproj.device
    if xproj.dim() != 3 or xproj.shape[2] % 4:
        raise ValueError(f"xproj must be [T, B, 4H], got {tuple(xproj.shape)}")
    T, B, G = xproj.shape
    H = G // 4
    if T < 1:
        raise ValueError("the kernel needs T >= 1")
    kernels.check_f32("xproj", xproj, (T, B, G), dev)
    kernels.check_f32("U", U, (H, G), dev)
    kernels.check_f32("h0", h0, (B, H), dev)
    kernels.check_f32("c0", c0, (B, H), dev)
    _check_mask(mask, T, B, dev)
    pl = plan("fwd", B, H, _num_sms(dev))
    ys = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    hT = torch.empty((B, H), dtype=torch.float32, device=dev)
    cT = torch.empty((B, H), dtype=torch.float32, device=dev)
    z = cs = None
    if save_residuals:
        z = torch.empty((T, B, G), dtype=torch.float32, device=dev)
        cs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    launch = kernels.launcher("lstm_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            xproj.data_ptr(), U.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            _ptr(mask), ys.data_ptr(), hT.data_ptr(), cT.data_ptr(), _ptr(z),
            _ptr(cs), T, B, H, pl.cluster, pl.units, pl.rows, pl.rows4,
            pl.ksplit, int(pl.smem_w), stream)
    if rc != 0:
        raise RuntimeError(f"lstm_fwd kernel launch failed: CUDA error {rc} "
                           f"(T={T} B={B} H={H}, {pl})")
    fwd_counts.bump("kernel")
    return (ys, hT, cT, z, cs) if save_residuals else (ys, hT, cT)


def _launch_bwd(z, c0, cs, dys, U, dhT, dcT, mask):
    dev = z.device
    if z.dim() != 3 or z.shape[2] % 4:
        raise ValueError(f"z must be [T, B, 4H], got {tuple(z.shape)}")
    T, B, G = z.shape
    H = G // 4
    if T < 1:
        raise ValueError("the kernel needs T >= 1")
    kernels.check_f32("z", z, (T, B, G), dev)
    kernels.check_f32("c0", c0, (B, H), dev)
    kernels.check_f32("cs", cs, (T, B, H), dev)
    kernels.check_f32("dys", dys, (T, B, H), dev)
    kernels.check_f32("U", U, (H, G), dev)
    kernels.check_f32("dhT", dhT, (B, H), dev)
    kernels.check_f32("dcT", dcT, (B, H), dev)
    _check_mask(mask, T, B, dev)
    pl = plan("bwd", B, H, _num_sms(dev))
    ut = U.T.contiguous()  # [4H, H]: the block's U rows as contiguous columns
    dz = torch.empty((T, B, G), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    launch = kernels.launcher("lstm_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            z.data_ptr(), dys.data_ptr(), cs.data_ptr(), c0.data_ptr(),
            _ptr(mask), ut.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
            dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), T, B, H,
            pl.cluster, pl.units, pl.rows, pl.rows4, pl.ksplit,
            int(pl.smem_w), stream)
    if rc != 0:
        raise RuntimeError(f"lstm_bwd kernel launch failed: CUDA error {rc} "
                           f"(T={T} B={B} H={H}, {pl})")
    bwd_counts.bump("kernel")
    return dz, dh0, dc0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def recurrence_forward(ctx, forward, xproj, U, h0, c0, mask):
    """The Function's forward over a kernel pair with this module's
    contract: ``forward`` runs with residuals, which are saved for
    :func:`recurrence_backward`."""
    ys, hT, cT, z, cs = forward(xproj, U, h0, c0, mask, save_residuals=True)
    ctx.save_for_backward(U, h0, c0, ys, z, cs, mask)
    return ys, hT, cT


def recurrence_backward(ctx, backward, dys, dhT, dcT):
    """The Function's backward: ``backward`` gives dz (= dxproj), dh0 and
    dc0; ``dU = h_prev^T dz`` is one matmul over T·B."""
    U, h0, c0, ys, z, cs, mask = ctx.saved_tensors
    dz, dh0, dc0 = backward(z, c0, cs, dys.contiguous(), U, dhT.contiguous(),
                            dcT.contiguous(), mask)
    T, B, G = dz.shape
    H = G // 4
    h_prev = torch.cat([h0[None], ys[:-1]], dim=0)
    dU = h_prev.reshape(T * B, H).T @ dz.reshape(T * B, G)
    return dz, dU, dh0, dc0, None


class LSTMRecurrence(torch.autograd.Function):
    """``(xproj [T,B,4H], U [H,4H], h0, c0, mask [T,B] or None) -> (ys
    [T,B,H], hT, cT)`` with the fused backward. Saves z and cs (the
    forward's residuals) for the backward; no gradient flows to the
    mask."""

    @staticmethod
    def forward(ctx, xproj, U, h0, c0, mask):
        return recurrence_forward(ctx, lstm_forward, xproj, U, h0, c0, mask)

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        return recurrence_backward(ctx, lstm_backward, dys, dhT, dcT)


def run_recurrence(function, forward, xproj, U, h0, c0, mask=None):
    """``function`` (an autograd Function over a kernel pair) when autograd
    needs it; ``forward`` alone, without residual writes, otherwise
    (``torch.no_grad``, eval, prefill)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xproj, U, h0, c0)):
        return function.apply(xproj, U, h0, c0, mask)
    return forward(xproj, U, h0, c0, mask)


def lstm_recurrence(xproj, U, h0, c0, mask=None):
    """The recurrence through the resident pair (:func:`run_recurrence`)."""
    return run_recurrence(LSTMRecurrence, lstm_forward, xproj, U, h0, c0,
                          mask)


def cuda_lstm_scan(params: LSTMParams, xs: torch.Tensor, carry=None, *,
                   mask: torch.Tensor | None = None, reverse: bool = False,
                   recurrence=lstm_recurrence):
    """One LSTM layer over ``xs`` [B, T, D] through ``recurrence`` (the
    resident pair's :func:`lstm_recurrence` unless told otherwise): the
    same contract as ``ops.scan.lstm_scan`` (``carry`` (h, c) each [B, H]
    or None; ``mask`` bool [B, T]; ``reverse``). Returns ``((hT, cT), ys
    [B, T, H])``."""
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
    xproj = torch.matmul(xs.transpose(0, 1), fused.kernel) + fused.bias
    m = None if mask is None else mask.transpose(0, 1).to(torch.float32).contiguous()
    ys, hT, cT = recurrence(xproj.contiguous(), fused.recurrent, h0, c0, m)
    ys = ys.transpose(0, 1)
    if reverse:
        ys = torch.flip(ys, dims=(1,))
    return (hT, cT), ys
