"""LSTM cell as pure functions on explicit parameter tuples.

Port of ``lstm_tensorspark_tpu/ops/lstm_cell.py``. Parameters are stored per
gate (``W_* [D, H]``, ``U_* [H, H]``, ``b_* [H]``) and fused once into
``kernel [D, 4H]`` / ``recurrent [H, 4H]`` / ``bias [4H]`` in gate order
i, f, g, o, so one recurrence step is ``x @ kernel + h @ recurrent + bias``
followed by the gate nonlinearities. The cell state ``c`` stays float32.
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


def fuse_params(params: LSTMParams) -> FusedLSTMParams:
    """Concatenate the per-gate matrices (gate order i, f, g, o) into
    contiguous fused kernels, once per forward pass or engine."""
    kernel = torch.cat([params.W_i, params.W_f, params.W_g, params.W_o], dim=1)
    recurrent = torch.cat([params.U_i, params.U_f, params.U_g, params.U_o], dim=1)
    bias = torch.cat([params.b_i, params.b_f, params.b_g, params.b_o])
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
    z = x @ fused.kernel
    z = z + h @ fused.recurrent
    z = z + fused.bias
    h_new, c_new = _gates(z, c)
    return (h_new, c_new), h_new


def lstm_step_hoisted(fused: FusedLSTMParams, carry, zx: torch.Tensor):
    """Step on a pre-projected input ``zx = x @ kernel + bias`` [B, 4H]:
    only ``h @ recurrent`` and the gates stay in the sequential loop."""
    h, c = carry
    z = zx + h @ fused.recurrent
    h_new, c_new = _gates(z, c)
    return (h_new, c_new), h_new


def zero_carry(batch: int, hidden_size: int, device=None):
    h = torch.zeros((batch, hidden_size), dtype=torch.float32, device=device)
    c = torch.zeros((batch, hidden_size), dtype=torch.float32, device=device)
    return (h, c)
