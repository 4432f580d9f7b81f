"""Fused speculative greedy window: the hand-written CUDA kernel and its
plain PyTorch version.

Replaces ``lstm_tensorspark_tpu/ops/pallas_decode.py::_spec_window_kernel``
(with its per-model step ``_model_step``; entered there through
``spec_window_call``). One call advances a packed batch of B rows by one
speculative step of ``k_draft`` = K:

1. **propose** — the draft LM decodes K greedy tokens from a copy of its
   carries (the copy is discarded);
2. **verify** — ``W = K + 1`` joint teacher-forced steps on ``[token,
   proposals...]``: the target emits its own argmax ``t`` while the window
   is alive, and the draft steps alongside on the same inputs. Both
   models' carries commit on the same emit mask. The window stays alive
   only while the session lives on and proposal ``i`` equals ``t``; the
   last step always closes it. The session latch (EOS and budget) is
   separate: a draft miss ends the window, never the session.

So each live row emits the longest agreeing prefix of the proposals plus
the target's correction — the plain greedy sequence, whatever the draft. A
row dead at entry emits ``PAD_TOKEN`` W times and keeps all four carry
arrays unchanged.

- :func:`spec_window` is the dispatch: a CPU tensor goes to
  :func:`spec_window_reference`; a CUDA tensor launches the kernel
  (``csrc/spec_window.cu``) or raises — there is no fallback.
- :func:`spec_window_reference` is the same function in plain PyTorch; the
  CPU tests hold it against the JAX kernel (interpret mode), and
  ``chip_smoke.py`` holds the kernel against it on the card.
- :func:`spec_smem_bytes` is the kernel's shared-memory plan; a shape over
  the card's 227 KB per block is refused before launch.
- :data:`counts` counts kernel launches (and reference dispatches).
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..ops.lstm_cell import lstm_step
from .cuda_decode import (
    MAX_LAYERS,
    MAX_SMEM_BYTES,
    PAD_TOKEN,
    DecodeWeights,
    _int_row,
)

counts = kernels.LaunchCounts()

_p, _i = ctypes.c_void_p, ctypes.c_int
_pp = ctypes.POINTER(ctypes.c_void_p)
# csrc/spec_window.cu::spec_window_launch
_ARGTYPES = ([_i]
             + [_p, _i, _i, _i, _pp, _pp, _pp, _p, _p]      # target
             + [_p, _i, _i, _i, _pp, _pp, _pp, _p, _p]      # draft
             + [_p] * 8 + [_i, _i]                          # carries, rows
             + [_p] * 8 + [_p])                             # outputs, stream


def spec_smem_bytes(num_layers: int, hidden: int, embed: int,
                    draft_layers: int, draft_hidden: int, draft_embed: int,
                    k_draft: int) -> int:
    """Shared memory of one block (f32 unless said): x [max(E, Ed)], the
    target's h and c [L, H], the draft's committed h and c and their
    propose-phase copy (4 × [Ld, Hd]), z [4·max(H, Hd)], and the K
    proposals (int32)."""
    floats = (max(embed, draft_embed) + 2 * num_layers * hidden
              + 4 * draft_layers * draft_hidden
              + 4 * max(hidden, draft_hidden))
    return 4 * floats + 4 * k_draft


def check_plan(num_layers: int, hidden: int, embed: int, draft_layers: int,
               draft_hidden: int, draft_embed: int, k_draft: int) -> int:
    """Raise ``ValueError`` for a shape the kernel does not take (more
    than ``MAX_LAYERS`` layers in either model, or more shared memory than
    a block may have); return the plan's bytes otherwise."""
    for who, n in (("target", num_layers), ("draft", draft_layers)):
        if not 1 <= n <= MAX_LAYERS:
            raise ValueError(f"spec_window kernel takes 1..{MAX_LAYERS} "
                             f"{who} layers, got {n}")
    nbytes = spec_smem_bytes(num_layers, hidden, embed, draft_layers,
                             draft_hidden, draft_embed, k_draft)
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"spec_window shape L={num_layers} H={hidden} E={embed}, draft "
            f"L={draft_layers} H={draft_hidden} E={draft_embed}, "
            f"k_draft={k_draft} needs {nbytes} bytes of shared memory per "
            f"block (> {MAX_SMEM_BYTES})")
    return nbytes


def spec_window(tw: DecodeWeights, dw: DecodeWeights, h, c, dh, dc, tokens,
                alive, remaining, eos_ids, *, k_draft: int):
    """Run one speculative window over gathered carries.

    ``tw``/``dw`` are the target's and the draft's decode weights (one
    vocabulary); ``h``/``c`` [L, B, H] and ``dh``/``dc`` [Ld, B, Hd] f32;
    ``tokens``/``remaining``/``eos_ids`` [B] int32 (``eos_ids`` -1 = none);
    ``alive`` [B] int32 or bool. Returns ``(h_out, c_out, dh_out, dc_out,
    toks [W, B] int32, next_tok [B] int32, alive_out [B] int32 (the
    session latch), rem_out [B] int32)`` with ``W = k_draft + 1``. CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream, without synchronising.
    """
    if k_draft < 1:
        raise ValueError(f"k_draft must be >= 1, got {k_draft}")
    if h.device.type == "cuda":
        return _launch(tw, dw, h, c, dh, dc, tokens, alive, remaining,
                       eos_ids, k_draft)
    if h.device.type == "cpu":
        counts.bump("reference")
        return spec_window_reference(tw, dw, h, c, dh, dc, tokens, alive,
                                     remaining, eos_ids, k_draft=k_draft)
    raise ValueError(f"unsupported device {h.device}")


def _model_step(weights: DecodeWeights, hs, cs, tok, *, head: bool):
    """One greedy step of one model on token ``tok`` [B] from carries
    ``hs``/``cs`` (lists of [B, H]): (logits or None, new hs, new cs),
    uncommitted — the caller latches."""
    emb = weights.embedding
    V = emb.shape[0]
    in_range = (tok >= 0) & (tok < V)
    x = emb.index_select(0, tok.clamp(0, V - 1).to(torch.long))
    x = torch.where(in_range[:, None], x, torch.zeros_like(x))
    new_hs, new_cs = [], []
    for fused, h, c in zip(weights.layers, hs, cs):
        (h, c), x = lstm_step(fused, (h, c), x)
        new_hs.append(h)
        new_cs.append(c)
    logits = x @ weights.head_kernel + weights.head_bias if head else None
    return logits, new_hs, new_cs


@torch.no_grad()
def spec_window_reference(tw: DecodeWeights, dw: DecodeWeights, h, c, dh,
                          dc, tokens, alive, remaining, eos_ids, *,
                          k_draft: int):
    """The speculative window in plain PyTorch (same signature and results
    as :func:`spec_window`), step for step as the JAX kernel computes it."""
    tok = tokens.to(torch.int32)
    alive = alive.to(torch.bool)
    rem = remaining.to(torch.int32)
    eos = eos_ids.to(torch.int32)
    hs, cs = list(h.unbind(0)), list(c.unbind(0))
    dhs0, dcs0 = list(dh.unbind(0)), list(dc.unbind(0))

    # phase 1: the draft proposes; its propose-time carries are discarded
    props = []
    phs, pcs, ptok = dhs0, dcs0, tok
    for _ in range(k_draft):
        logits, phs, pcs = _model_step(dw, phs, pcs, ptok, head=True)
        ptok = torch.argmax(logits, dim=-1).to(torch.int32)
        props.append(ptok)

    # phase 2: W joint teacher-forced verify steps
    dhs, dcs = dhs0, dcs0
    sess_alive, final_tok = alive, tok
    toks = []
    for i in range(k_draft + 1):
        inp = tok if i == 0 else props[i - 1]
        logits, new_hs, new_cs = _model_step(tw, hs, cs, inp, head=True)
        _, new_dhs, new_dcs = _model_step(dw, dhs, dcs, inp, head=False)
        t = torch.argmax(logits, dim=-1).to(torch.int32)
        emit = alive
        toks.append(torch.where(emit, t, torch.full_like(t, PAD_TOKEN)))
        new_rem = rem - emit.to(torch.int32)
        hit_eos = emit & (eos >= 0) & (t == eos)
        live_on = ~hit_eos & (new_rem > 0)
        sess_alive = torch.where(emit, live_on, sess_alive)
        if i < k_draft:
            alive = emit & live_on & (props[i] == t)
        else:  # past the last proposal nothing can agree
            alive = torch.zeros_like(emit)
        keep = emit[:, None]
        hs = [torch.where(keep, n, o) for o, n in zip(hs, new_hs)]
        cs = [torch.where(keep, n, o) for o, n in zip(cs, new_cs)]
        dhs = [torch.where(keep, n, o) for o, n in zip(dhs, new_dhs)]
        dcs = [torch.where(keep, n, o) for o, n in zip(dcs, new_dcs)]
        final_tok = torch.where(emit, t, final_tok)
        rem = new_rem
    next_tok = torch.where(sess_alive, final_tok, torch.zeros_like(final_tok))
    return (torch.stack(hs), torch.stack(cs), torch.stack(dhs),
            torch.stack(dcs), torch.stack(toks), next_tok,
            sess_alive.to(torch.int32), rem)


def _check_weights(who: str, w: DecodeWeights, L: int, H: int, V: int, dev):
    E = w.embedding.shape[1]
    kernels.check_f32(f"{who} embedding", w.embedding, (V, E), dev)
    for l, f in enumerate(w.layers):
        D = E if l == 0 else H
        kernels.check_f32(f"{who} layer {l} kernel", f.kernel, (D, 4 * H), dev)
        kernels.check_f32(f"{who} layer {l} recurrent", f.recurrent,
                          (H, 4 * H), dev)
        kernels.check_f32(f"{who} layer {l} bias", f.bias, (4 * H,), dev)
    kernels.check_f32(f"{who} head kernel", w.head_kernel, (H, V), dev)
    kernels.check_f32(f"{who} head bias", w.head_bias, (V,), dev)


def _ptr_arrays(w: DecodeWeights):
    ptrs = ctypes.c_void_p * len(w.layers)
    return (ptrs(*(f.kernel.data_ptr() for f in w.layers)),
            ptrs(*(f.recurrent.data_ptr() for f in w.layers)),
            ptrs(*(f.bias.data_ptr() for f in w.layers)))


def _launch(tw, dw, h, c, dh, dc, tokens, alive, remaining, eos_ids,
            k_draft):
    dev = h.device
    L, B, H = h.shape
    Ld, _, Hd = dh.shape
    V, E = tw.embedding.shape
    Ed = dw.embedding.shape[1]
    if len(tw.layers) != L or len(dw.layers) != Ld:
        raise ValueError(f"layers do not match the carries: target "
                         f"{len(tw.layers)} vs {L}, draft {len(dw.layers)} "
                         f"vs {Ld}")
    check_plan(L, H, E, Ld, Hd, Ed, k_draft)
    if dw.embedding.shape[0] != V:
        raise ValueError(f"draft vocab {dw.embedding.shape[0]} != target "
                         f"vocab {V}")
    kernels.check_f32("h", h, (L, B, H), dev)
    kernels.check_f32("c", c, (L, B, H), dev)
    kernels.check_f32("draft h", dh, (Ld, B, Hd), dev)
    kernels.check_f32("draft c", dc, (Ld, B, Hd), dev)
    _check_weights("target", tw, L, H, V, dev)
    _check_weights("draft", dw, Ld, Hd, V, dev)
    tok = _int_row("tokens", tokens, B, dev)
    alv = _int_row("alive", alive, B, dev)
    rem = _int_row("remaining", remaining, B, dev)
    eos = _int_row("eos_ids", eos_ids, B, dev)

    W = k_draft + 1
    toks = torch.empty((W, B), dtype=torch.int32, device=dev)
    row_out = torch.empty((3, B), dtype=torch.int32, device=dev)
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    dh_out, dc_out = torch.empty_like(dh), torch.empty_like(dc)
    Ws, Us, bs = _ptr_arrays(tw)
    dWs, dUs, dbs = _ptr_arrays(dw)
    launch = kernels.launcher("spec_window", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            V,
            tw.embedding.data_ptr(), E, L, H, Ws, Us, bs,
            tw.head_kernel.data_ptr(), tw.head_bias.data_ptr(),
            dw.embedding.data_ptr(), Ed, Ld, Hd, dWs, dUs, dbs,
            dw.head_kernel.data_ptr(), dw.head_bias.data_ptr(),
            h.data_ptr(), c.data_ptr(), dh.data_ptr(), dc.data_ptr(),
            tok.data_ptr(), alv.data_ptr(), rem.data_ptr(), eos.data_ptr(),
            B, k_draft, toks.data_ptr(), row_out[0].data_ptr(),
            row_out[1].data_ptr(), row_out[2].data_ptr(), h_out.data_ptr(),
            c_out.data_ptr(), dh_out.data_ptr(), dc_out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"spec_window kernel launch failed: CUDA error {rc} (L={L} "
            f"H={H} E={E} Ld={Ld} Hd={Hd} Ed={Ed} V={V} B={B} "
            f"k_draft={k_draft})")
    counts.bump("kernel")
    return (h_out, c_out, dh_out, dc_out, toks, row_out[0], row_out[1],
            row_out[2])
