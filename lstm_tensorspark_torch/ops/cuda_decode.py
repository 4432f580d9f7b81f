"""Fused K-step decode window: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces ``lstm_tensorspark_tpu/ops/pallas_decode.py::_decode_window_kernel``
(entered there through ``decode_window_call``). One call advances a packed
batch of B rows by K tokens: per step the embedding row, L fused LSTM cells,
the head, greedy argmax or Gumbel-argmax ``argmax(logits / max(t, 1e-6) +
noise[k])``, then the per-row EOS / budget / alive latches. Rows dead at a
step's entry emit ``PAD_TOKEN``, keep their carries frozen and feed token 0.

- :func:`decode_window` is the dispatch: a CPU tensor goes to
  :func:`decode_window_reference`; a CUDA tensor launches the kernel
  (``csrc/decode_window.cu``) or raises — there is no fallback.
- :func:`decode_window_reference` is the same function in plain PyTorch;
  the CPU tests hold it against the JAX kernel (interpret mode), and
  ``chip_smoke.py`` holds the kernel against it on the card.
- :data:`counts` counts kernel launches (and reference dispatches), so a
  run can show its decode steps went through the kernel.

On the card the kernel is bound by memory traffic, not arithmetic: decode
at serving batch sizes is matrix-vector work (see the note at the top of
the CUDA source for what the design does about it).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from ..ops.lstm_cell import FusedLSTMParams, lstm_step

#: emitted for a dead row's steps (the serving wire contract)
PAD_TOKEN = -1
MAX_LAYERS = 8  # csrc/decode_window.cu MAX_LAYERS
#: dynamic shared memory the kernel may use: the card's 227 KB per block,
#: less room for the kernel's static reduction scratch
MAX_SMEM_BYTES = 232448 - 1024


def sampling_supported(temperature: float, top_k, top_p, greedy: bool) -> bool:
    """Greedy and pure temperature sampling (at any temperature, a runtime
    argument of the kernel); top-k / top-p are not ported. The one home of
    this rule: ``models.generate.check_sampling`` refuses what it declines."""
    return greedy or (top_k is None and top_p is None)


def smem_bytes(num_layers: int, hidden: int, embed: int) -> int:
    """Shared memory of one block: x [E], h and c [L, H], z [4H] (f32)."""
    return 4 * (embed + 2 * num_layers * hidden + 4 * hidden)


class DecodeWeights(NamedTuple):
    """The weights one decode window reads, laid out for the kernel:
    embedding [V, E], fused layers (kernel [D, 4H], recurrent [H, 4H],
    bias [4H]), head kernel [H, V] (contiguous; for a tied head a copy of
    ``embedding.T`` made once) and head bias [V]."""

    embedding: torch.Tensor
    layers: tuple[FusedLSTMParams, ...]
    head_kernel: torch.Tensor
    head_bias: torch.Tensor


def decode_weights(params, fused_layers, tie_embeddings: bool) -> DecodeWeights:
    kernel = (params["embedding"].T if tie_embeddings
              else params["head"]["kernel"])
    return DecodeWeights(params["embedding"].contiguous(),
                         tuple(fused_layers), kernel.contiguous(),
                         params["head"]["bias"].contiguous())


counts = kernels.LaunchCounts()

_p, _i = ctypes.c_void_p, ctypes.c_int
_pp = ctypes.POINTER(ctypes.c_void_p)
# csrc/decode_window.cu::decode_window_launch
_ARGTYPES = [_p, _i, _i, _i, _i, _pp, _pp, _pp, _p, _p, _p, _p, _p, _p, _p,
             _p, _p, _i, _i, ctypes.c_float, _i, _i, _p, _p, _p, _p, _p, _p,
             _p]


def decode_window(weights: DecodeWeights, h, c, tokens, alive, remaining,
                  eos_ids, noise, *, window: int, temperature: float,
                  greedy: bool):
    """Run one K-step decode window over gathered carries.

    ``h``/``c`` [L, B, H] f32; ``tokens``/``remaining``/``eos_ids`` [B]
    int32 (``eos_ids`` -1 = none); ``alive`` [B] int32 (1 live, 0 dead; a
    bool tensor is taken too); ``noise`` [K, B, V] f32 Gumbel draws (None
    when greedy). Returns ``(h_out, c_out, toks [K, B] int32, next_tok [B]
    int32, alive_out [B] int32, rem_out [B] int32)``. CPU tensors run the plain version; CUDA tensors launch the
    kernel on the current stream, without synchronising.
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if h.device.type == "cuda":
        return _launch(weights, h, c, tokens, alive, remaining, eos_ids,
                       noise, window, temperature, greedy)
    if h.device.type == "cpu":
        counts.bump("reference")
        return decode_window_reference(
            weights, h, c, tokens, alive, remaining, eos_ids, noise,
            window=window, temperature=temperature, greedy=greedy)
    raise ValueError(f"unsupported device {h.device}")


@torch.no_grad()
def decode_window_reference(weights: DecodeWeights, h, c, tokens, alive,
                            remaining, eos_ids, noise, *, window: int,
                            temperature: float, greedy: bool):
    """The decode window in plain PyTorch (same signature and results as
    :func:`decode_window`)."""
    emb = weights.embedding
    V = emb.shape[0]
    hs, cs = list(h.unbind(0)), list(c.unbind(0))
    tok = tokens.to(torch.int32)
    alive = alive.to(torch.bool)
    rem = remaining.to(torch.int32)
    eos = eos_ids.to(torch.int32)
    tdiv = None
    if not greedy and temperature != 1.0:
        # a tensor divisor: true division, as the kernel and the JAX
        # package compute it (a Python-scalar divisor may become a
        # reciprocal multiply on the card)
        tdiv = torch.full((), max(temperature, 1e-6), dtype=torch.float32,
                          device=h.device)
    toks = []
    for k in range(window):
        in_range = (tok >= 0) & (tok < V)
        x = emb.index_select(0, tok.clamp(0, V - 1).to(torch.long))
        x = torch.where(in_range[:, None], x, torch.zeros_like(x))
        new = []
        for l, fused in enumerate(weights.layers):
            (hn, cn), x = lstm_step(fused, (hs[l], cs[l]), x)
            new.append((hn, cn))
        logits = x @ weights.head_kernel + weights.head_bias
        if greedy:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            if tdiv is not None:
                logits = logits / tdiv
            nxt = torch.argmax(logits + noise[k], dim=-1).to(torch.int32)
        emit = alive
        toks.append(torch.where(emit, nxt, torch.full_like(nxt, PAD_TOKEN)))
        new_rem = rem - emit.to(torch.int32)
        hit_eos = emit & (eos >= 0) & (nxt == eos)
        new_alive = emit & ~hit_eos & (new_rem > 0)
        hs = [torch.where(emit[:, None], hn, ho) for ho, (hn, _) in zip(hs, new)]
        cs = [torch.where(emit[:, None], cn, co) for co, (_, cn) in zip(cs, new)]
        tok = torch.where(new_alive, nxt, torch.zeros_like(nxt))
        alive, rem = new_alive, new_rem
    return (torch.stack(hs), torch.stack(cs), torch.stack(toks), tok,
            alive.to(torch.int32), rem)


def _int_row(name, t, B, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != (B,):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({B},)")
    if t.dtype.is_floating_point or t.dtype.is_complex:
        raise TypeError(f"{name} must be an integer or bool tensor")
    return t.to(torch.int32).contiguous()


def _launch(weights, h, c, tokens, alive, remaining, eos_ids, noise, window,
            temperature, greedy):
    dev = h.device
    L, B, H = h.shape
    V, E = weights.embedding.shape
    if not 1 <= L <= MAX_LAYERS or len(weights.layers) != L:
        raise ValueError(f"kernel takes 1..{MAX_LAYERS} layers matching the "
                         f"carries; got {len(weights.layers)} layers, "
                         f"carries of {L}")
    nbytes = smem_bytes(L, H, E)
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"shape L={L} H={H} E={E} needs {nbytes} bytes of "
                         f"shared memory per block (> {MAX_SMEM_BYTES})")
    kernels.check_f32("h", h, (L, B, H), dev)
    kernels.check_f32("c", c, (L, B, H), dev)
    kernels.check_f32("embedding", weights.embedding, (V, E), dev)
    for l, f in enumerate(weights.layers):
        D = E if l == 0 else H
        kernels.check_f32(f"layer {l} kernel", f.kernel, (D, 4 * H), dev)
        kernels.check_f32(f"layer {l} recurrent", f.recurrent, (H, 4 * H), dev)
        kernels.check_f32(f"layer {l} bias", f.bias, (4 * H,), dev)
    kernels.check_f32("head kernel", weights.head_kernel, (H, V), dev)
    kernels.check_f32("head bias", weights.head_bias, (V,), dev)
    tok = _int_row("tokens", tokens, B, dev)
    alv = _int_row("alive", alive, B, dev)
    rem = _int_row("remaining", remaining, B, dev)
    eos = _int_row("eos_ids", eos_ids, B, dev)
    if greedy:
        noise_ptr = None
    else:
        if noise is None:
            raise ValueError("temperature sampling needs noise [K, B, V]")
        kernels.check_f32("noise", noise, (window, B, V), dev)
        noise_ptr = noise.data_ptr()

    toks = torch.empty((window, B), dtype=torch.int32, device=dev)
    row_out = torch.empty((3, B), dtype=torch.int32, device=dev)
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    ptrs = ctypes.c_void_p * L
    Ws = ptrs(*(f.kernel.data_ptr() for f in weights.layers))
    Us = ptrs(*(f.recurrent.data_ptr() for f in weights.layers))
    bs = ptrs(*(f.bias.data_ptr() for f in weights.layers))
    scale = int(not greedy and temperature != 1.0)
    launch = kernels.launcher("decode_window", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            weights.embedding.data_ptr(), V, E, L, H, Ws, Us, bs,
            weights.head_kernel.data_ptr(), weights.head_bias.data_ptr(),
            h.data_ptr(), c.data_ptr(), tok.data_ptr(), alv.data_ptr(),
            rem.data_ptr(), eos.data_ptr(), noise_ptr, B, window,
            max(temperature, 1e-6), scale, int(greedy), toks.data_ptr(),
            row_out[0].data_ptr(), row_out[1].data_ptr(),
            row_out[2].data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"decode_window kernel launch failed: CUDA error "
                           f"{rc} (L={L} B={B} H={H} E={E} V={V} K={window})")
    counts.bump("kernel")
    return h_out, c_out, toks, row_out[0], row_out[1], row_out[2]
