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
- :func:`plan` is the launch plan of both window kernels (this one and
  ``ops/cuda_spec.py``'s), testable on the CPU; :func:`card_plan` the plan
  for a card. :func:`sliced_argmax` is the plain twin of the kernels'
  argmax: per-block slices of V merged by value, then lower index.
- :data:`counts` counts kernel launches (and reference dispatches), so a
  run can show its decode steps went through the kernel;
  :data:`counts_bf16` those of the bfloat16 form.

Two forms, chosen by the dtype of the fused layers' W and U: float32, and
bfloat16 under bf16 compute (JAX's ``_decode_window_kernel`` at a bfloat16
``w_ref.dtype``): x and h are rounded to bfloat16 at the layers' products,
which accumulate in float32; the embedding, the head, the bias, the
carries and the gate math stay float32. ``DecodeWeights.ldtype`` bfloat16
(JAX's ``ldtype``) rounds the logits as JAX's head does: the float32 sum to
bfloat16, plus the bias rounded to bfloat16, in bfloat16, then widened.

On the card the kernel is bound by memory traffic, not arithmetic: decode
at serving batch sizes is matrix-vector work. The kernel spreads each step
over many blocks, each owning a slice of the hidden units and of the head's
columns for every row, so each weight is read once per step for the whole
batch (see the note at the top of ``csrc/decode_common.cuh``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from .. import kernels
from ..ops.lstm_cell import FusedLSTMParams, lstm_step
from . import cuda_lstm

#: emitted for a dead row's steps (the serving wire contract)
PAD_TOKEN = -1
MAX_LAYERS = 8  # csrc/decode_common.cuh MAX_LAYERS
THREADS = 256  # csrc THREADS
MAX_RT = 16  # csrc MAX_RT: batch rows of a tile
MAX_SMEM_BYTES = 232448  # 227 KB per block (csrc MAX_SMEM_BYTES)
#: the sizes of a one-cluster launch the plan tries, in order: when every
#: weight slice of the models fits a block's shared memory over one cluster,
#: the blocks meet at the cluster's hardware barrier
CLUSTERS = (16, 8)
#: the least staging room (d-rows of x at 16 batch rows) the plan leaves
#: when it keeps weight slices in shared memory; a wider x goes in chunks
MIN_STAGE = 256
INT_MAX = 2**31 - 1


def sampling_supported(temperature: float, top_k, top_p, greedy: bool) -> bool:
    """The sampling configs the window kernel computes: greedy and pure
    temperature sampling (at any temperature, a runtime argument of the
    kernel). Top-k / top-p need a sort over V; the engine dispatches
    those to its scan window (JAX's ``pallas_decode.sampling_supported``
    rule)."""
    return greedy or (top_k is None and top_p is None)


class WindowPlan(NamedTuple):
    """How a window launch is cut (``csrc/decode_common.cuh``). ``blocks``
    blocks, each owning ``units[i]`` hidden units of model i at most (all
    four gate columns of a unit) and ``head_cols`` of the V head columns.
    ``cluster``: the launch is one cluster of ``blocks`` (1: every block
    holds the whole head and embedding, so a step meets at one cluster
    barrier per layer, and the state — h, c — lives in every block's
    shared memory) or a cooperative grid, one block an SM (0: each block a
    slice of the head, whose partial argmaxes meet at one more barrier;
    counters in global memory, the state in global scratch).
    ``layers_smem`` / ``head_smem``: the blocks keep their slices of every
    model's layers / heads in shared memory for the window, else they read
    them through L2 each step. ``rows_smem``: the rows' latches in shared
    memory (else in global scratch, a copy a block: only for batches of
    thousands of rows). ``stage`` is the d-rows of x a block stages at 16
    batch rows (a wider x goes in chunks).
    ``smem_bytes`` is what one block asks for. ``offchip_bytes[i]`` is
    model i's (layers, head) weight bytes that do not stay on chip, read
    once per step."""

    blocks: int
    cluster: int
    units: tuple[int, ...]
    head_cols: int
    layers_smem: bool
    head_smem: bool
    rows_smem: bool
    stage: int
    smem_bytes: int
    offchip_bytes: tuple[tuple[int, int], ...]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _r4(n: int) -> int:
    """n rounded up to 16 bytes of floats (csrc ``r4``: every piece of
    shared memory starts on 16 bytes)."""
    return -(-n // 4) * 4


def _layer_bytes(L: int, H: int, E: int, nu: int, esize: int) -> int:
    """A block's slice of a model's layers in shared memory (csrc
    ``layers_bytes``): a layer's weights [(D_l + H)][4nu] (unit-major: a
    unit's four gates side by side) at ``esize`` bytes an element, rounded
    up to 16 bytes, then its float32 bias [4nu]."""
    return sum(_r4(((E if l == 0 else H) + H) * nu * esize) * 4 + 16 * nu
               for l in range(L))


def _check_shapes(models, vocab: int) -> None:
    for L, H, E in models:
        if not 1 <= L <= MAX_LAYERS:
            raise ValueError(f"window kernels take 1..{MAX_LAYERS} layers, "
                             f"got {L}")
        if H < 1 or E < 1:
            raise ValueError(f"window kernels need hidden, embed >= 1, got "
                             f"H={H} E={E}")
    if vocab < 1:
        raise ValueError(f"window kernels need a vocabulary, got {vocab}")


def plan(models: Sequence[tuple[int, int, int]], vocab: int, batch: int,
         k_draft: int | None = None, num_sms: int = 132,
         clusters: dict[int, int] | None = None,
         esize: int = 4) -> WindowPlan:
    """The launch plan of a window over ``models`` ((num_layers, hidden,
    embed) each: the decode window's one model, or with ``k_draft`` the
    spec window's target and draft) sharing a vocabulary of ``vocab``, for
    ``batch`` rows. Mirrors ``window_smem_bytes`` of
    ``csrc/decode_common.cuh``.

    One cluster of ``CLUSTERS[i]`` blocks when every model's layer
    slices, whole head and embedding, the rows' latches and the state fit
    shared memory there (and ``clusters``, the card's resident clusters by size,
    if given, keeps one); else one block per SM, keeping in shared memory
    the latches and what fits of the weights (layers and heads, layers,
    heads, or neither), the rest read through L2 each step. Rows go in
    tiles of 16. ``esize`` is the bytes of an element of W and U (2 in the
    bfloat16 form; the head and the embedding stay float32). Raises
    ``ValueError`` for more than ``MAX_LAYERS`` layers or an empty
    width."""
    _check_shapes(models, vocab)
    # csrc: decode_window.cu R_FIELDS, spec_window.cu S_FIELDS + K; the
    # state arrays of each model ([L, B, H] each): h of two steps and c,
    # and for the draft its propose copy's too
    fields = 4 if k_draft is None else 8 + k_draft
    copies = (3,) if k_draft is None else (3, 6)
    dtot = _ceil(max(max(E, H) + H for L, H, E in models), 8) * 8
    weights = [(esize * ((E + H) * 4 * H + (L - 1) * 8 * H * H) + 16 * H * L,
                4 * (H * vocab + vocab)) for L, H, E in models]

    def build(blocks, cluster, wsm, hsm, rsm):
        units = tuple(_ceil(H, blocks) for _, H, _ in models)
        cols = vocab if cluster else _ceil(vocab, blocks)
        floats = THREADS * MAX_RT + 2 * MAX_RT
        floats += _r4(fields * batch) if rsm else 0
        if cluster:
            floats += sum(n * _r4(L * batch * H) + _r4(vocab * E)
                          for n, (L, H, E) in zip(copies, models))
        if wsm:  # whole 16-byte pieces: a multiple of 4 floats
            floats += sum(_layer_bytes(L, H, E, nu, esize) // 4
                          for (L, H, E), nu in zip(models, units))
        if hsm:
            floats += sum(_r4((H + 1) * cols) for _, H, _ in models)
        room = (MAX_SMEM_BYTES // 4 - floats) // MAX_RT // 8 * 8
        stage = min(dtot, room)
        if stage < (min(dtot, MIN_STAGE) if wsm or hsm or cluster else 8):
            return None
        offchip = tuple((0 if wsm else lw, 0 if hsm else hw)
                        for lw, hw in weights)
        return WindowPlan(blocks, cluster, units, cols, wsm, hsm, rsm, stage, 4 * (floats + stage * MAX_RT), offchip)

    for C in CLUSTERS:
        if clusters is None or clusters.get(C, 0) >= 1:
            p = build(C, 1, True, True, True)
            if p is not None:
                return p
    for rsm in (True, False):
        for wsm, hsm in ((True, True), (True, False), (False, True),
                         (False, False)):
            p = build(num_sms, 0, wsm, hsm, rsm)
            if p is not None:
                return p
    # the last option (the least shared memory) always fits
    raise AssertionError("no window plan fits a block's shared memory")


_plans: dict[tuple, WindowPlan] = {}


def card_plan(models: Sequence[tuple[int, int, int]], vocab: int, batch: int,
              k_draft: int | None, dev, esize: int = 4) -> WindowPlan:
    """:func:`plan` for the card ``dev``: its SM count and the clusters of
    window blocks it keeps resident, each block asking for the most shared
    memory (``csrc/decode_window.cu::decode_window_max_clusters``; cached by
    shape). Refuses a shape :func:`plan` refuses
    before it asks the card anything."""
    key = (dev.index or 0, tuple(models), vocab, batch, k_draft, esize)
    p = _plans.get(key)
    if p is None:
        _check_shapes(models, vocab)
        p = _plans[key] = plan(
            models, vocab, batch, k_draft, cuda_lstm._num_sms(dev),
            {C: kernels.max_clusters("decode_window", dev, C, MAX_SMEM_BYTES)
             for C in CLUSTERS}, esize)
    return p


_counters_cache: dict[tuple[int, int], torch.Tensor] = {}


def sync_counters(dev, stream: int) -> torch.Tensor:
    """The two int32 counters of the window kernels' barrier on ``dev`` for
    launches on ``stream``: zeroed once, and left at zero by every launch
    (the last block out resets them), so no launch resets them from the
    host."""
    key = (dev.index or 0, stream)
    t = _counters_cache.get(key)
    if t is None:
        t = _counters_cache[key] = torch.zeros(2, dtype=torch.int32,
                                               device=dev)
    return t


def _split(n: int, parts: int, j: int) -> int:
    return n * j // parts


@torch.no_grad()
def sliced_argmax(logits: torch.Tensor, blocks: int) -> torch.Tensor:
    """The window kernels' argmax in plain PyTorch: V cut into ``blocks``
    balanced slices; in a slice each of 32 lanes walks its columns (lane,
    lane + 32, ...) in order keeping the first maximum (the first column
    even when all are -inf), the lanes and then the slices merge by larger
    value, then lower index; a slice with no columns gives (-inf,
    INT_MAX). Rows of ``logits`` [B, V]; returns [B] int64, what
    ``jnp.argmax`` / ``torch.argmax`` give on rows without NaN."""
    B, V = logits.shape
    neg = torch.full((B,), -float("inf"), dtype=logits.dtype,
                     device=logits.device)
    none = torch.full((B,), INT_MAX, dtype=torch.int64, device=logits.device)

    def merge(bv, bi, v, i):
        take = (v > bv) | ((v == bv) & (i < bi))
        return torch.where(take, v, bv), torch.where(take, i, bi)

    best_v, best_i = neg, none
    for j in range(blocks):
        lo, hi = _split(V, blocks, j), _split(V, blocks, j + 1)
        sv, si = neg, none
        for lane in range(min(32, hi - lo)):
            cols = torch.arange(lo + lane, hi, 32, device=logits.device)
            at = torch.argmax(logits[:, cols], dim=1)  # its first maximum
            sv, si = merge(sv, si, logits[:, cols].gather(1, at[:, None])[:, 0],
                           cols[at])
        best_v, best_i = merge(best_v, best_i, sv, si)
    return best_i


class DecodeWeights(NamedTuple):
    """The weights one decode window reads, laid out for the kernel:
    embedding [V, E], fused layers (kernel [D, 4H], recurrent [H, 4H] —
    both float32, or both bfloat16 — and a float32 bias [4H]), head kernel
    [H, V] (contiguous; for a tied head a copy of ``embedding.T`` made
    once) and head bias [V], and ``ldtype``, the dtype of the logits (JAX's
    ``LMConfig.ldtype``)."""

    embedding: torch.Tensor
    layers: tuple[FusedLSTMParams, ...]
    head_kernel: torch.Tensor
    head_bias: torch.Tensor
    ldtype: torch.dtype = torch.float32


def decode_weights(params, fused_layers, tie_embeddings: bool,
                   ldtype: torch.dtype = torch.float32) -> DecodeWeights:
    kernel = (params["embedding"].T if tie_embeddings
              else params["head"]["kernel"])
    return DecodeWeights(params["embedding"].contiguous(),
                         tuple(fused_layers), kernel.contiguous(),
                         params["head"]["bias"].contiguous(), ldtype)


def layers_dtype(weights: DecodeWeights) -> torch.dtype:
    """The form a window runs, by the dtype of its fused W and U: float32
    or bfloat16 (``TypeError`` for another, or for a mix)."""
    dts = {t.dtype for f in weights.layers for t in (f.kernel, f.recurrent)}
    if len(dts) != 1 or not dts <= {torch.float32, torch.bfloat16}:
        raise TypeError(f"the layers' W and U must all be float32 or all "
                        f"bfloat16, got {sorted(map(str, dts))}")
    return dts.pop()


@torch.no_grad()
def window_logits(x: torch.Tensor, weights: DecodeWeights) -> torch.Tensor:
    """The head of the plain versions, float32 out: ``x @ kernel + bias``,
    or under a bfloat16 ``ldtype`` the float32 product rounded to bfloat16
    plus the bias rounded to bfloat16, in bfloat16 (JAX's ``dot(...,
    preferred_element_type=ldtype) + bias.astype(ldtype)``)."""
    if weights.ldtype == torch.float32:
        return x @ weights.head_kernel + weights.head_bias
    ld = weights.ldtype
    return ((x @ weights.head_kernel).to(ld)
            + weights.head_bias.to(ld)).float()


counts = kernels.LaunchCounts("decode_window")
counts_bf16 = kernels.LaunchCounts("decode_window_bf16")

_p, _i = ctypes.c_void_p, ctypes.c_int
_pp = ctypes.POINTER(ctypes.c_void_p)
# csrc/decode_window.cu::decode_window_launch (and decode_window_bf16.cu::
# decode_window_bf16_launch): the model
# (lbf16 last), the carries and rows, B, K, tdiv, scale, greedy, the plan
# (blocks, cluster, layers, head and rows in shared memory, stage), the
# scratch, the outputs, the stream
_ARGTYPES = ([_p, _i, _i, _i, _i, _pp, _pp, _pp, _p, _p, _i]
             + [_p] * 7 + [_i, _i, ctypes.c_float, _i, _i]
             + [_i] * 6 + [_p] * 5 + [_p] * 6 + [_p])


def decode_window(weights: DecodeWeights, h, c, tokens, alive, remaining,
                  eos_ids, noise, *, window: int, temperature: float,
                  greedy: bool):
    """Run one K-step decode window over gathered carries.

    ``h``/``c`` [L, B, H] f32; ``tokens``/``remaining``/``eos_ids`` [B]
    int32 (``eos_ids`` -1 = none); ``alive`` [B] int32 (1 live, 0 dead; a
    bool tensor is taken too); ``noise`` [K, B, V] f32 Gumbel draws (None
    when greedy). Returns ``(h_out, c_out, toks [K, B] int32, next_tok [B]
    int32, alive_out [B] int32, rem_out [B] int32)``. CPU tensors run the
    plain version; CUDA tensors launch the kernel's form of the layers'
    dtype on the current stream, without synchronising.
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if h.device.type == "cuda":
        return _launch(weights, h, c, tokens, alive, remaining, eos_ids,
                       noise, window, temperature, greedy)
    if h.device.type == "cpu":
        cuda_lstm.counts_of(layers_dtype(weights), counts, counts_bf16).bump(
            "reference")
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
        logits = window_logits(x, weights)
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


def source(dtype: torch.dtype, name: str) -> str:
    """The kernel source (library) of a window's form: ``name``, or
    ``name + "_bf16"`` for the bfloat16 form."""
    return name + "_bf16" if dtype == torch.bfloat16 else name


def lbf16(weights: DecodeWeights) -> int:
    """The kernels' flag of a bfloat16 ``ldtype`` (``TypeError`` for a
    dtype they do not take)."""
    if weights.ldtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits dtype must be float32 or bfloat16, got "
                        f"{weights.ldtype}")
    return int(weights.ldtype == torch.bfloat16)


def check_weights(who: str, w: DecodeWeights, L: int, H: int, V: int,
                  dev) -> None:
    """Raise unless ``w`` is what the window kernels read for a model of
    ``L`` layers of width ``H`` over ``V`` tokens on ``dev``: W and U in
    the form's dtype, the rest float32, contiguous."""
    wd = layers_dtype(w)
    E = w.embedding.shape[1]
    kernels.check_f32(f"{who}embedding", w.embedding, (V, E), dev)
    for l, f in enumerate(w.layers):
        D = E if l == 0 else H
        kernels.check_operand(f"{who}layer {l} kernel", f.kernel,
                              (D, 4 * H), dev, wd)
        kernels.check_operand(f"{who}layer {l} recurrent", f.recurrent,
                              (H, 4 * H), dev, wd)
        kernels.check_f32(f"{who}layer {l} bias", f.bias, (4 * H,), dev)
    kernels.check_f32(f"{who}head kernel", w.head_kernel, (H, V), dev)
    kernels.check_f32(f"{who}head bias", w.head_bias, (V,), dev)


def _launch(weights, h, c, tokens, alive, remaining, eos_ids, noise, window,
            temperature, greedy):
    dev = h.device
    L, B, H = h.shape
    V, E = weights.embedding.shape
    if len(weights.layers) != L:
        raise ValueError(f"the carries have {L} layers, the weights "
                         f"{len(weights.layers)}")
    wd = layers_dtype(weights)
    pl = card_plan(((L, H, E),), V, B, None, dev, cuda_lstm.esize_of(wd))
    kernels.check_f32("h", h, (L, B, H), dev)
    kernels.check_f32("c", c, (L, B, H), dev)
    check_weights("", weights, L, H, V, dev)
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

    hc = torch.empty((2, L, B, H), dtype=torch.float32, device=dev)
    h_out, c_out = hc[0], hc[1]
    # scratch: h of two steps and the head's partials (in shared memory in
    # a one-cluster launch), each block's latches (unless on chip)
    hbuf = part_v = None
    if not pl.cluster:
        fs = torch.empty(2 * L * B * H + B * pl.blocks, dtype=torch.float32,
                         device=dev)
        hbuf = fs.data_ptr()
        part_v = hbuf + 4 * 2 * L * B * H
    nrows = 0 if pl.rows_smem else pl.blocks * 4 * B
    ints = torch.empty((window + 3) * B + B * pl.blocks + nrows,
                       dtype=torch.int32, device=dev)
    toks = ints[:window * B].view(window, B)
    row_out = ints[window * B:(window + 3) * B].view(3, B)
    part_i = ints.data_ptr() + 4 * (window + 3) * B
    rows = part_i + 4 * B * pl.blocks
    ptrs = ctypes.c_void_p * L
    Ws = ptrs(*(f.kernel.data_ptr() for f in weights.layers))
    Us = ptrs(*(f.recurrent.data_ptr() for f in weights.layers))
    bs = ptrs(*(f.bias.data_ptr() for f in weights.layers))
    scale = int(not greedy and temperature != 1.0)
    launch = kernels.launcher(source(wd, "decode_window"), _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            weights.embedding.data_ptr(), V, E, L, H, Ws, Us, bs,
            weights.head_kernel.data_ptr(), weights.head_bias.data_ptr(),
            lbf16(weights), h.data_ptr(), c.data_ptr(), tok.data_ptr(), alv.data_ptr(),
            rem.data_ptr(), eos.data_ptr(), noise_ptr, B, window,
            max(temperature, 1e-6), scale, int(greedy), pl.blocks,
            pl.cluster, int(pl.layers_smem), int(pl.head_smem), pl.stage,
            int(pl.rows_smem), hbuf, part_v, part_i, rows,
            sync_counters(dev, stream).data_ptr(),
            toks.data_ptr(), row_out.data_ptr(), row_out.data_ptr() + 4 * B,
            row_out.data_ptr() + 8 * B, h_out.data_ptr(), c_out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"decode_window kernel launch failed: CUDA error "
                           f"{rc} (L={L} B={B} H={H} E={E} V={V} K={window}, "
                           f"{wd}, {pl})")
    cuda_lstm.counts_of(wd, counts, counts_bf16).bump("kernel")
    return h_out, c_out, toks, row_out[0], row_out[1], row_out[2]
