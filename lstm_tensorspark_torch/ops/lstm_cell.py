"""LSTM cell as pure functions on explicit parameter tuples.

Port of ``lstm_tensorspark_tpu/ops/lstm_cell.py``. Parameters are stored per
gate (``W_* [D, H]``, ``U_* [H, H]``, ``b_* [H]``) and fused once into
``kernel [D, 4H]`` / ``recurrent [H, 4H]`` / ``bias [4H]`` in gate order
i, f, g, o, so one recurrence step is ``x @ kernel + h @ recurrent + bias``
followed by the gate nonlinearities. The cell state ``c`` stays float32.

Under a bfloat16 compute dtype (``fuse_params(..., compute_dtype=)``) the
fused ``kernel`` and ``recurrent`` are bfloat16 and the bias stays
float32; x and h are rounded to bfloat16 only at the product, which
accumulates in float32 (:func:`mm_f32`, JAX's ``preferred_element_type=
float32``); c and the h carry stay float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

GATE_ORDER = ("i", "f", "g", "o")  # input, forget, cell-candidate, output


class LSTMParams(NamedTuple):
    """Per-gate parameters: W_* [input_size, hidden], U_* [hidden, hidden],
    b_* [hidden]."""

    W_i: torch.Tensor
    W_f: torch.Tensor
    W_g: torch.Tensor
    W_o: torch.Tensor
    U_i: torch.Tensor
    U_f: torch.Tensor
    U_g: torch.Tensor
    U_o: torch.Tensor
    b_i: torch.Tensor
    b_f: torch.Tensor
    b_g: torch.Tensor
    b_o: torch.Tensor

    @property
    def input_size(self) -> int:
        return self.W_i.shape[0]

    @property
    def hidden_size(self) -> int:
        return self.W_i.shape[1]


class FusedLSTMParams(NamedTuple):
    """Gate-fused view: kernel [D, 4H], recurrent [H, 4H], bias [4H]."""

    kernel: torch.Tensor
    recurrent: torch.Tensor
    bias: torch.Tensor

    @property
    def hidden_size(self) -> int:
        return self.recurrent.shape[0]


def glorot_uniform(gen: torch.Generator, shape: tuple[int, int]) -> torch.Tensor:
    """Glorot/Xavier uniform on a 2-D ``(fan_in, fan_out)`` shape."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return u * (2.0 * limit) - limit


def orthogonal(gen: torch.Generator, shape: tuple[int, int]) -> torch.Tensor:
    """Orthogonal matrix from the QR of a normal draw, with the sign of
    ``diag(R)`` folded in so the distribution is uniform (Haar)."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen,
                    dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return (q if rows >= cols else q.T).contiguous()


def init_lstm_params(gen: torch.Generator, input_size: int, hidden_size: int,
                     *, forget_bias: float = 1.0) -> LSTMParams:
    """Glorot-uniform input kernels, orthogonal recurrent kernels, zero
    biases except the forget gate (``forget_bias``). Drawn on the CPU from
    ``gen`` so a seed gives the same weights whatever device serves them."""
    Ws = [glorot_uniform(gen, (input_size, hidden_size)) for _ in range(4)]
    Us = [orthogonal(gen, (hidden_size, hidden_size)) for _ in range(4)]
    zeros = torch.zeros((hidden_size,), dtype=torch.float32)
    biases = [zeros, torch.full((hidden_size,), float(forget_bias)),
              zeros.clone(), zeros.clone()]
    return LSTMParams(*Ws, *Us, *biases)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype) -> torch.dtype:
    """A compute dtype given by name (``"float32"``, ``"bfloat16"``), as a
    ``torch.dtype`` or None (float32) → the ``torch.dtype``."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        if dtype in COMPUTE_DTYPES.values():
            return dtype
    elif dtype in COMPUTE_DTYPES:
        return COMPUTE_DTYPES[dtype]
    raise ValueError(f"compute dtype must be one of {sorted(COMPUTE_DTYPES)},"
                     f" got {dtype!r}")


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``b`` 2-D) accumulated in float32 (JAX's ``jnp.dot(...,
    preferred_element_type=float32)``). On bfloat16 operands the products
    are exact in float32, so this is JAX's product up to the order of the
    sum; ``torch.matmul`` of two bfloat16 tensors would round its result
    to bfloat16 once more. On the card, outside autograd (the kernel
    routes' Functions), bfloat16 operands go to ``torch.mm(...,
    out_dtype=float32)``: the tensor cores, float32 sums; a torch without
    that overload raises. Else (the CPU, which has no kernel for it; the
    plain loop under autograd, whose gradients then round as JAX's do) the
    operands are widened to float32 first. On float32 operands it is
    ``a @ b``."""
    if (a.dtype == b.dtype == torch.bfloat16 and a.is_cuda
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad))):
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def fuse_params(params: LSTMParams, compute_dtype=None) -> FusedLSTMParams:
    """Concatenate the per-gate matrices (gate order i, f, g, o) into
    contiguous fused kernels, once per forward pass or engine. With a
    ``compute_dtype`` (e.g. ``torch.bfloat16`` or ``"bfloat16"``) the
    kernel and recurrent matrices are cast to it; the bias stays float32
    (JAX ``fuse_params``)."""
    kernel = torch.cat([params.W_i, params.W_f, params.W_g, params.W_o], dim=1)
    recurrent = torch.cat([params.U_i, params.U_f, params.U_g, params.U_o], dim=1)
    bias = torch.cat([params.b_i, params.b_f, params.b_g, params.b_o])
    if compute_dtype is not None:
        dt = resolve_dtype(compute_dtype)
        kernel, recurrent = kernel.to(dt), recurrent.to(dt)
    return FusedLSTMParams(kernel.contiguous(), recurrent.contiguous(),
                           bias.contiguous())


def _gates(z: torch.Tensor, c: torch.Tensor):
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_step(fused: FusedLSTMParams, carry, x: torch.Tensor):
    """One step: carry ``(h, c)`` each [B, H], x [B, D] →
    ``((h', c'), h')``."""
    h, c = carry
    dt = fused.kernel.dtype
    z = mm_f32(x.to(dt), fused.kernel)
    z = z + mm_f32(h.to(dt), fused.recurrent)
    z = z + fused.bias
    h_new, c_new = _gates(z, c)
    return (h_new, c_new), h_new


def lstm_step_hoisted(fused: FusedLSTMParams, carry, zx: torch.Tensor):
    """Step on a pre-projected input ``zx = x @ kernel + bias`` [B, 4H]:
    only ``h @ recurrent`` and the gates stay in the sequential loop."""
    h, c = carry
    z = zx + mm_f32(h.to(fused.recurrent.dtype), fused.recurrent)
    h_new, c_new = _gates(z, c)
    return (h_new, c_new), h_new


def zero_carry(batch: int, hidden_size: int, device=None):
    h = torch.zeros((batch, hidden_size), dtype=torch.float32, device=device)
    c = torch.zeros((batch, hidden_size), dtype=torch.float32, device=device)
    return (h, c)
