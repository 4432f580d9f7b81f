"""Bucketed prefill and kernel-driven decode over the recurrent-state cache.

Port of the single-device, single-model part of
``lstm_tensorspark_tpu/serve/engine.py``:

- **prefill** — gather each row's carries by slot, run the masked
  ``lm_backbone`` over the right-padded prompt (the mask freezes carries at
  padded steps), scatter the advanced carries back, and sample the first
  token from the head at each row's last true position, in the config's
  logits dtype (``head_logits``). On the card the recurrence runs the
  recurrence kernels' forward; under bf16 compute in their plain-rounding
  form (``plain_rounding``: a float32 projection), since JAX's serve
  prefill is the plain XLA scan, whose rounding the windows' first tokens
  must follow.
- **bf16** — a ``compute_dtype`` bfloat16 config serves through the
  windows' bfloat16 forms (W and U fused in bfloat16, the bias, the
  embedding and the head float32, as JAX's ``fuse_params`` leaves them);
  ``logits_dtype`` bfloat16 rounds every head's logits as JAX's does.
- **decode windows** — every decode step goes through
  ``ops/cuda_decode.decode_window``: on the card that is the hand-written
  window kernel, on the CPU its plain version. ``decode`` (K=1) is the
  window at ``window=1`` with ``remaining=1`` and no EOS, which the latch
  algebra makes identical to a single decode step. A window returns device
  handles (:class:`DecodeWindow`); ``decode_window_next`` chains the next
  window from them before the host reads the previous one. Everything runs
  in order on PyTorch's current stream, and each window's small summary
  (tokens, remaining, alive) is copied to pinned host memory behind a CUDA
  event, so ``fetch_window`` waits for that window alone.
- **speculative windows** (greedy only) — with a draft LM attached
  (``attach_draft``), ``spec_window`` runs one draft-and-verify step
  through ``ops/cuda_spec.spec_window`` (the hand-written kernel on the
  card): the draft proposes ``k_draft`` tokens and the target verifies them
  in one teacher-forced pass, emitting 1..k_draft+1 tokens per row — the
  plain greedy sequence, whatever the draft. The draft keeps its own state
  per slot (``draft_cache``), advanced over each prompt by
  ``draft_prefill`` (the batcher mirrors every prefill) and committed by
  the verify pass. ``spec_window_next`` chains from device handles as
  ``decode_window_next`` does.

**Sessions and prefixes** — prefill items are ``(dst_slot, src_slot,
fresh, prompt)`` quads (a ``(slot, fresh, prompt)`` triple means src ==
dst): each row's carries are gathered from ``src`` (a prefix-cache slot
for a resumed prefill, the session's own slot otherwise, zero when
``fresh``) and the advanced carries are written to ``dst``. The gather
copies before anything is written, so a refcounted prefix slot is only
ever read. ``prefill_chunk`` runs an intermediate chunk of a long prompt:
the same body without the head. With ``prefix_cache`` the engine owns a
:class:`~.state_cache.PrefixCache` (``prefix``); with ``tiered_cache`` or
a ``session_dir`` a :class:`~.state_cache.SessionTiers` (``tiers``):
evicted sessions spill to host RAM and to disk and fill back. The cache
stays float32 in both compute dtypes, so a session file holds the same
bytes whichever dtype served it.

**Telemetry** — ``registry`` (default ``obs.REGISTRY``; ``obs.
NULL_REGISTRY`` disables it) is the stack's one registry: the engine keeps
it as ``metrics`` and hands it to the state cache, the prefix cache and
the tiers, and the batcher, the router and the server read it from here.

Every host-visible batch is padded to a bucket: prompts to a length
bucket, batches to a batch bucket with dead rows at the cache's scratch
slot. Sampling: greedy, or temperature sampling by Gumbel-argmax with noise
drawn from the engine's own ``torch.Generator`` (seeded by ``rng_seed``).
Top-k and top-p are refused with ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from .. import obs
from ..device import configure_precision, resolve_device
from ..kernels import LaunchCounts
from ..models.generate import check_sampling, fuse_layers, gumbel_noise, sample_logits
from ..models.lstm_lm import (LMConfig, _head_kernel, head_logits,
                              lm_backbone, params_to)
from ..ops import cuda_decode, cuda_spec
from ..ops.cuda_lstm import counts_of
from ..ops.cuda_decode import PAD_TOKEN
from .state_cache import DetachedState, PrefixCache, SessionTiers, StateCache

__all__ = ["PAD_TOKEN", "GREEDY", "SamplingParams", "DecodeWindow",
           "ServeEngine"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling config (batches group by :meth:`key`)."""

    temperature: float = 1.0
    top_k: int | None = None
    top_p: float | None = None
    greedy: bool = False

    def key(self) -> tuple:
        return (self.temperature, self.top_k, self.top_p, self.greedy)


GREEDY = SamplingParams(greedy=True)


@dataclasses.dataclass(frozen=True)
class DecodeWindow:
    """A dispatched (possibly still running) decode window.

    ``tokens`` [batch_b, window], ``next_tokens``/``alive``/``remaining``
    [batch_b], ``slots``/``eos_ids`` [batch_b] are device tensors — what a
    follow-up window needs. ``summary`` is the host copy of (tokens,
    remaining, alive) packed as int32, valid once ``ready`` (a CUDA event,
    None on the CPU) has completed."""

    tokens: torch.Tensor
    next_tokens: torch.Tensor
    alive: torch.Tensor
    remaining: torch.Tensor
    slots: torch.Tensor
    eos_ids: torch.Tensor
    batch_b: int
    window: int
    n: int  # live (non-padding) rows; fetch strips the rest
    sampling: SamplingParams
    summary: torch.Tensor
    ready: object = None
    t_dispatch: float = 0.0
    # a speculative window (spec_window): ``window`` is W = k_draft + 1,
    # the most tokens it can emit, and its successor goes through
    # spec_window_next (it also threads the draft's carries)
    spec: bool = False


def _bucket_for(value: int, buckets: tuple[int, ...], what: str) -> int:
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f"{what} {value} exceeds the largest bucket {buckets[-1]}")


class ServeEngine:
    """Owns the params, the fused decode weights, the state cache and the
    sampling generator. Thread-safe: one lock serialises dispatch."""

    def __init__(self, params, cfg: LMConfig, *,
                 device: str | torch.device = "cuda",
                 num_slots: int = 64,
                 prefill_buckets: tuple[int, ...] = (8, 16, 32, 64, 128),
                 batch_buckets: tuple[int, ...] = (1, 2, 4, 8, 16),
                 rng_seed: int = 0,
                 prefix_cache: bool = False,
                 prefix_stride: int = 8,
                 prefix_entries: int = 16,
                 tiered_cache: bool = False,
                 host_tier_entries: int = 256,
                 session_dir: str | None = None,
                 registry=None):
        self.device = resolve_device(device)
        configure_precision()
        # serving never rematerialises (the same override as generate())
        if cfg.remat_chunk is not None:
            cfg = dataclasses.replace(cfg, remat_chunk=None)
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.fused_layers = fuse_layers(self.params, cfg)  # once, at init
        self.weights = cuda_decode.decode_weights(
            self.params, self.fused_layers, cfg.tie_embeddings, cfg.ldtype)
        self.decode_kernel = "cuda" if self.device.type == "cuda" else "reference"
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.batch_buckets = tuple(sorted(batch_buckets))
        # the one model this engine serves, under the JAX engine's default
        # id (the server's serve_model_info gauge reads it)
        self.model_id = "default"
        self.model_version = 0
        self.metrics = obs.REGISTRY if registry is None else registry
        self.cache = StateCache(cfg.num_layers, num_slots, cfg.hidden_size,
                                device=self.device, registry=self.metrics)
        # a session_dir alone implies the tiers: durability needs the
        # spill plane
        self.tiers = (
            SessionTiers(self.cache, host_entries=host_tier_entries,
                         directory=session_dir, registry=self.metrics)
            if (tiered_cache or session_dir is not None) else None)
        # with tiers attached, an evicted backing slot spills the entry
        # instead of invalidating it
        self.prefix = (
            PrefixCache(self.cache, stride=prefix_stride,
                        max_entries=prefix_entries, tiers=self.tiers,
                        registry=self.metrics)
            if prefix_cache else None)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed)
        self._lock = threading.RLock()
        self._counts_lock = threading.Lock()
        self.dispatches = {"prefill": 0, "prefill_chunk": 0, "decode": 0,
                           "decode_window": 0, "draft_prefill": 0,
                           "spec_window": 0}
        # speculative serving: the draft's weights and config, and its
        # per-slot state (attach_draft)
        self.draft: dict | None = None
        self.draft_cache: StateCache | None = None

    # ---- limits --------------------------------------------------------

    @property
    def max_prompt_len(self) -> int:
        return self.prefill_buckets[-1]

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    # ---- the draft (speculative serving) ---------------------------------

    @property
    def has_draft(self) -> bool:
        return self.draft is not None

    def attach_draft(self, draft_params, draft_cfg: LMConfig) -> None:
        """Install the draft LM that proposes tokens for
        :meth:`spec_window`. It must share the target's vocabulary. Greedy
        output stays the plain greedy sequence whatever its weights: they
        move only how many proposals the target accepts. The draft's state
        (``draft_cache``: ``[Ld, num_slots + 1, Hd]`` f32, the same slot
        indexing as the state cache; only its device tensors are used)
        starts at zero, which is always safe for the same reason."""
        if draft_cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{self.cfg.vocab_size} — proposals must share the token "
                "space they are verified in")
        if draft_cfg.compute_dtype != self.cfg.compute_dtype:
            raise ValueError(
                f"draft compute dtype {draft_cfg.compute_dtype} != target "
                f"{self.cfg.compute_dtype}: one spec window runs one form "
                "(the draft inherits the target's, train/distill.py)")
        if draft_cfg.remat_chunk is not None:
            draft_cfg = dataclasses.replace(draft_cfg, remat_chunk=None)
        params = params_to(draft_params, self.device)
        fused = fuse_layers(params, draft_cfg)
        draft = {"params": params, "cfg": draft_cfg,
                 "weights": cuda_decode.decode_weights(
                     params, fused, draft_cfg.tie_embeddings,
                     draft_cfg.ldtype)}
        # the draft's slots record no telemetry (the JAX engine keeps
        # them as bare arrays, outside the cache families)
        cache = StateCache(draft_cfg.num_layers, self.cache.num_slots,
                           draft_cfg.hidden_size, device=self.device,
                           registry=obs.NULL_REGISTRY)
        with self._lock:
            self.draft, self.draft_cache = draft, cache

    def _require_draft(self, what: str) -> dict:
        if self.draft is None:
            raise ValueError(f"{what} needs an attached draft (attach_draft)")
        return self.draft

    # ---- helpers ---------------------------------------------------------

    def check_sampling(self, sampling: SamplingParams) -> None:
        """Raise ``ValueError`` for a config this engine will not serve
        (top-k / top-p). Temperature is a runtime argument of the kernel,
        so any number of distinct temperatures is served."""
        check_sampling(sampling.temperature, sampling.top_k, sampling.top_p,
                       sampling.greedy)

    def _count(self, phase: str) -> None:
        with self._counts_lock:
            self.dispatches[phase] += 1

    def _to_device(self, slots: np.ndarray, *rows: np.ndarray,
                   n_index: int = 1):
        """Host slot indices + int32 rows → device tensors in ONE
        host-to-device copy; the first ``n_index`` rows (slot indices) come
        back int64, the index type of ``index_select``/``index_copy_``."""
        packed = torch.from_numpy(np.stack([slots, *rows]).astype(np.int32))
        out = list(packed.to(self.device).unbind(0))
        for i in range(n_index):
            out[i] = out[i].to(torch.long)
        return out

    def _noise(self, shape) -> torch.Tensor:
        return gumbel_noise(shape, generator=self._gen, device=self.device)

    # ---- prefill ---------------------------------------------------------

    @staticmethod
    def _norm_prefill_items(items):
        """Prefill items as ``(dst_slot, src_slot, fresh, prompt)`` quads;
        a ``(slot, fresh, prompt)`` triple prefills in place (src == dst)."""
        out = []
        for it in items:
            if len(it) == 3:
                slot, fresh, prompt = it
                out.append((slot, slot, fresh, prompt))
            else:
                out.append(tuple(it))
        return out

    def _pack_prefill(self, items):
        """Pad normalised items to the (batch, length) buckets: ``(src,
        dst, fresh, lens, prompts, n)`` host arrays. Final and intermediate
        chunks share one length-bucket lattice (``prefill_buckets``)."""
        n = len(items)
        lengths = [int(np.asarray(p).size) for _, _, _, p in items]
        if min(lengths) < 1:
            raise ValueError("empty prompt")
        batch_b = _bucket_for(n, self.batch_buckets, "prefill batch")
        len_b = _bucket_for(max(lengths), self.prefill_buckets, "prompt length")
        scratch = self.cache.scratch_slot
        src = np.full((batch_b,), scratch, np.int32)
        dst = np.full((batch_b,), scratch, np.int32)
        fresh = np.ones((batch_b,), np.int32)
        lens = np.ones((batch_b,), np.int32)
        prompts = np.zeros((batch_b, len_b), np.int32)
        for i, (d, sl, is_fresh, prompt) in enumerate(items):
            p = np.asarray(prompt, np.int32).reshape(-1)
            dst[i], src[i], fresh[i], lens[i] = d, sl, bool(is_fresh), p.size
            prompts[i, :p.size] = p
        return src, dst, fresh, lens, prompts, n

    def _consume(self, params, cfg: LMConfig, cache: StateCache, items):
        """The prefill body every prefill shares: gather each row's carries
        from its src slot (fresh rows from zero), run the masked
        ``lm_backbone`` over the right-padded prompts (the mask freezes
        carries at padded steps) and scatter the advanced carries to the
        dst slots. The gather copies first, so a prefix slot read here is
        never written. Returns ``(ys [B, T, H], lengths [B] on the device,
        n)``."""
        src, dst, fresh, lens, prompts, n = self._pack_prefill(
            self._norm_prefill_items(items))
        src_d, dst_d, fresh_d, lens_d = self._to_device(src, dst, fresh, lens,
                                                        n_index=2)
        prompts_d = torch.from_numpy(prompts).to(self.device)
        h_in, c_in = cache.read_slots(src_d)
        live = (fresh_d == 0)[None, :, None]
        h_in = torch.where(live, h_in, torch.zeros_like(h_in))
        c_in = torch.where(live, c_in, torch.zeros_like(c_in))
        carries = [(h_in[l], c_in[l]) for l in range(cfg.num_layers)]
        mask = (torch.arange(prompts.shape[1], device=self.device)[None, :]
                < lens_d[:, None])
        finals, ys = lm_backbone(params, prompts_d, cfg, carries=carries,
                                 mask=mask, plain_rounding=True)
        cache.write_slots(dst_d, torch.stack([f[0] for f in finals]),
                          torch.stack([f[1] for f in finals]))
        return ys, lens_d, n

    @torch.no_grad()
    def prefill(self, items, sampling: SamplingParams = GREEDY) -> np.ndarray:
        """Run one bucketed prefill batch: the final (or only) chunk of
        each row's prompt, ending with the head and the sampler. ``items``
        are ``(slot, fresh, prompt)`` triples or ``(dst_slot, src_slot,
        fresh, prompt)`` quads (``prompt`` 1-D int, 1..max_prompt_len
        tokens; ``fresh`` rows start from zero carries). Returns the first
        sampled token per item, ``[len(items)]`` int32."""
        if len(items) == 0:
            return np.zeros((0,), np.int32)
        self.check_sampling(sampling)
        with self._lock:
            ys, lens_d, n = self._consume(self.params, self.cfg, self.cache,
                                          items)
            rows = torch.arange(ys.shape[0], device=self.device)
            last = ys[rows, (lens_d - 1).to(torch.long)]  # [B, H]
            kernel, bias = _head_kernel(self.params, self.cfg)
            logits = head_logits(last, kernel, bias, self.cfg)
            noise = None if sampling.greedy else self._noise(logits.shape)
            token = sample_logits(logits, temperature=sampling.temperature,
                                  greedy=sampling.greedy, noise=noise)
            self._count("prefill")
            out = token.cpu().numpy()
        return out[:n]

    @torch.no_grad()
    def prefill_chunk(self, items) -> None:
        """Dispatch one INTERMEDIATE prefill chunk batch: advance each
        row's state over its chunk tokens and scatter it — no head, no
        sampling, nothing returned (the final chunk, through
        :meth:`prefill`, emits the first token). ``items`` as in
        :meth:`prefill`."""
        if len(items) == 0:
            return
        with self._lock:
            self._consume(self.params, self.cfg, self.cache, items)
            self._count("prefill_chunk")

    @torch.no_grad()
    def draft_prefill(self, items) -> None:
        """Advance the draft's slot state over prompt fragments, as
        :meth:`prefill_chunk` advances the target's: the batcher mirrors
        every prefill dispatch (chunks and finals) with one of these, so
        the draft's carries track the context each session consumed.
        ``items`` are ``(slot, fresh, fragment)`` triples; ``fresh`` starts
        the draft from zero (a session's first fragment, prefix-resumed
        and tier-filled rows included: the draft has no prefix entries or
        tier copies, and starting cold only lowers acceptance). Enqueued,
        nothing returned."""
        draft = self._require_draft("draft_prefill")
        if len(items) == 0:
            return
        with self._lock:
            self._consume(draft["params"], draft["cfg"], self.draft_cache,
                          items)
            self._count("draft_prefill")

    # ---- decode ----------------------------------------------------------

    def _dispatch_window(self, slots_d, tokens_d, alive_d, rem_d, eos_d, *,
                         batch_b: int, window: int, n: int,
                         sampling: SamplingParams) -> DecodeWindow:
        """Gather → window (kernel on the card) → scatter, all enqueued on
        the current stream; the summary copy is queued right behind the
        window so a later fetch waits for this window only."""
        h_in, c_in = self.cache.read_slots(slots_d)
        noise = (None if sampling.greedy
                 else self._noise((window, batch_b, self.cfg.vocab_size)))
        h_out, c_out, toks, next_tok, alive, rem = cuda_decode.decode_window(
            self.weights, h_in, c_in, tokens_d, alive_d, rem_d, eos_d, noise,
            window=window, temperature=sampling.temperature,
            greedy=sampling.greedy)
        self.cache.write_slots(slots_d, h_out, c_out)
        return self._window_handles(
            toks, next_tok, alive, rem, slots_d, eos_d, batch_b=batch_b,
            n=n, sampling=sampling, spec=False)

    def _window_handles(self, toks, next_tok, alive, rem, slots_d, eos_d, *,
                        batch_b: int, n: int, sampling: SamplingParams,
                        spec: bool) -> DecodeWindow:
        """Wrap a dispatched window's device outputs (``toks`` [K, B]) as a
        :class:`DecodeWindow`, with its summary copy queued right behind
        it on the current stream."""
        toks = toks.T  # [K, B] → [B, K]
        packed = torch.cat([toks.reshape(-1), rem, alive])
        ready = None
        if packed.is_cuda:
            summary = torch.empty(packed.shape, dtype=torch.int32,
                                  pin_memory=True)
            summary.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        else:
            summary = packed
        return DecodeWindow(
            tokens=toks, next_tokens=next_tok, alive=alive, remaining=rem,
            slots=slots_d, eos_ids=eos_d, batch_b=batch_b,
            window=toks.shape[1], n=n, sampling=sampling, summary=summary,
            ready=ready, t_dispatch=time.perf_counter(), spec=spec)

    def _pack_rows(self, slots, tokens, remaining, eos_ids):
        """Per-row host values padded to the batch bucket (scratch slot,
        dead): ``(batch_b, (slots, tokens, alive, remaining, eos))``."""
        n = len(slots)
        batch_b = _bucket_for(n, self.batch_buckets, "decode batch")
        slots_p = np.full((batch_b,), self.cache.scratch_slot, np.int32)
        slots_p[:n] = slots
        tokens_p = np.zeros((batch_b,), np.int32)
        tokens_p[:n] = tokens
        rem_p = np.zeros((batch_b,), np.int32)
        rem_p[:n] = remaining
        eos_p = np.full((batch_b,), -1, np.int32)
        if eos_ids is not None:
            eos_p[:n] = eos_ids
        alive_p = (rem_p > 0).astype(np.int32)
        alive_p[n:] = 0
        return batch_b, (slots_p, tokens_p, alive_p, rem_p, eos_p)

    @torch.no_grad()
    def decode_window(self, slots, tokens, remaining, eos_ids=None,
                      sampling: SamplingParams = GREEDY, *,
                      window: int) -> DecodeWindow:
        """Dispatch one K-token decode window and return device handles
        (no sync — pair with :meth:`fetch_window`). ``slots``/``tokens``/
        ``remaining`` are per-row host values; ``eos_ids`` uses -1 for "no
        eos". Rows are padded to the batch bucket (scratch slot, dead).
        Rows latch dead on device when they emit their eos or exhaust
        ``remaining``, so ``window`` may exceed a row's budget safely."""
        n = len(slots)
        if n == 0 or window < 1:
            raise ValueError(f"decode_window needs rows and window >= 1, "
                             f"got {n} rows, window {window}")
        self.check_sampling(sampling)
        batch_b, rows = self._pack_rows(slots, tokens, remaining, eos_ids)
        with self._lock:
            slots_d, tokens_d, alive_d, rem_d, eos_d = self._to_device(*rows)
            win = self._dispatch_window(
                slots_d, tokens_d, alive_d, rem_d, eos_d,
                batch_b=batch_b, window=window, n=n, sampling=sampling)
            self._count("decode_window")
        return win

    @torch.no_grad()
    def decode_window_next(self, prev: DecodeWindow, *,
                           window: int | None = None) -> DecodeWindow:
        """Dispatch the follow-up window for the same packed rows from
        ``prev``'s device handles — callable before ``prev`` is fetched.
        Rows ``prev`` latched dead stay frozen."""
        if prev.spec:
            raise ValueError("decode_window_next needs a plain window; a "
                             "speculative one chains with spec_window_next")
        window = prev.window if window is None else window
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        with self._lock:
            win = self._dispatch_window(
                prev.slots, prev.next_tokens, prev.alive, prev.remaining,
                prev.eos_ids, batch_b=prev.batch_b, window=window, n=prev.n,
                sampling=prev.sampling)
            self._count("decode_window")
        return win

    def _dispatch_spec(self, slots_d, tokens_d, alive_d, rem_d, eos_d, *,
                       batch_b: int, n: int, k_draft: int) -> DecodeWindow:
        """Gather both models' carries → the spec kernel (on the card) →
        scatter both, all enqueued on the current stream; the summary copy
        is queued right behind, as for a plain window."""
        h_in, c_in = self.cache.read_slots(slots_d)
        dh_in, dc_in = self.draft_cache.read_slots(slots_d)
        (h_out, c_out, dh_out, dc_out, toks, next_tok, alive,
         rem) = cuda_spec.spec_window(
            self.weights, self.draft["weights"], h_in, c_in, dh_in, dc_in,
            tokens_d, alive_d, rem_d, eos_d, k_draft=k_draft)
        self.cache.write_slots(slots_d, h_out, c_out)
        self.draft_cache.write_slots(slots_d, dh_out, dc_out)
        self._count("spec_window")
        return self._window_handles(
            toks, next_tok, alive, rem, slots_d, eos_d, batch_b=batch_b,
            n=n, sampling=GREEDY, spec=True)

    @torch.no_grad()
    def spec_window(self, slots, tokens, remaining, eos_ids=None, *,
                    k_draft: int) -> DecodeWindow:
        """Dispatch one speculative step (greedy): the draft proposes
        ``k_draft`` tokens, the target verifies them in one teacher-forced
        pass of ``W = k_draft + 1`` steps, and each row emits its longest
        agreeing prefix plus the target's correction (1..W tokens, PAD
        after). Returns a :class:`DecodeWindow` with ``spec=True`` and
        ``window = W`` — fetch with :meth:`fetch_window_summary`, chain
        with :meth:`spec_window_next`. Rows are padded as in
        :meth:`decode_window`."""
        self._require_draft("spec_window")
        n = len(slots)
        if n == 0 or k_draft < 1:
            raise ValueError(f"spec_window needs rows and k_draft >= 1, got "
                             f"{n} rows, k_draft {k_draft}")
        batch_b, rows = self._pack_rows(slots, tokens, remaining, eos_ids)
        with self._lock:
            slots_d, tokens_d, alive_d, rem_d, eos_d = self._to_device(*rows)
            return self._dispatch_spec(slots_d, tokens_d, alive_d, rem_d,
                                       eos_d, batch_b=batch_b, n=n,
                                       k_draft=k_draft)

    @torch.no_grad()
    def spec_window_next(self, prev: DecodeWindow, *,
                         k_draft: int | None = None) -> DecodeWindow:
        """Dispatch the follow-up speculative step for the same packed rows
        from ``prev``'s device handles (``prev.next_tokens`` is each row's
        last emitted token, so the successor verifies from exactly the
        committed state) — callable before ``prev`` is fetched.
        ``k_draft`` may differ from ``prev``'s."""
        if not prev.spec:
            raise ValueError("spec_window_next needs a speculative window")
        self._require_draft("spec_window_next")
        k = prev.window - 1 if k_draft is None else k_draft
        if k < 1:
            raise ValueError(f"k_draft must be >= 1, got {k}")
        with self._lock:
            return self._dispatch_spec(
                prev.slots, prev.next_tokens, prev.alive, prev.remaining,
                prev.eos_ids, batch_b=prev.batch_b, n=prev.n, k_draft=k)

    def decode(self, slots, tokens,
               sampling: SamplingParams = GREEDY) -> np.ndarray:
        """Advance each session one token: the window at K=1 with
        ``remaining=1`` and no EOS. Returns the next token per row [B]."""
        n = len(slots)
        if n == 0:
            return np.zeros((0,), np.int32)
        win = self.decode_window(slots, tokens, [1] * n, None, sampling,
                                 window=1)
        self._count("decode")
        return self.fetch_window(win)[:, 0]

    @staticmethod
    def fetch_window_summary(win: DecodeWindow):
        """Block until the window's summary is on the host: ``(tokens [n,
        K], remaining [n], alive [n] bool)`` — the windowed path's only
        sync point, waiting on this window alone."""
        if win.ready is not None:
            win.ready.synchronize()
        flat = win.summary.numpy()
        B, K, n = win.batch_b, win.window, win.n
        toks = flat[:B * K].reshape(B, K)
        rem = flat[B * K:B * K + B]
        alive = flat[B * K + B:].astype(bool)
        return toks[:n].copy(), rem[:n].copy(), alive[:n]

    @classmethod
    def fetch_window(cls, win: DecodeWindow) -> np.ndarray:
        """``[n, K]`` int32 tokens of the window (``PAD_TOKEN`` after a
        row's EOS or budget end), padding rows stripped."""
        return cls.fetch_window_summary(win)[0]

    def warmup(self, sampling: SamplingParams = GREEDY,
               prompt_lens: tuple[int, ...] = (1,),
               windows: tuple[int, ...] = (1,),
               spec_windows: tuple[int, ...] = (),
               chunk_lens: tuple[int, ...] = ()) -> int:
        """Run every (batch bucket x length bucket) prefill, every (batch
        bucket x length bucket of ``chunk_lens``) intermediate chunk, and
        every (batch bucket x K) decode window once against the scratch
        slot before traffic: on the card this builds and loads the
        kernels, so the first request pays neither. With a draft attached,
        also a draft prefill per length bucket and a speculative window per
        ``spec_windows`` rung (k_draft >= 1); with tiers, the fill path's
        scatters. Returns the number of warm-up dispatches."""
        len_buckets = sorted({_bucket_for(t, self.prefill_buckets,
                                          "prompt length")
                              for t in prompt_lens})
        chunk_buckets = sorted({_bucket_for(t, self.prefill_buckets,
                                            "chunk length")
                                for t in chunk_lens})
        scratch = self.cache.scratch_slot
        runs = 0
        for bb in self.batch_buckets:
            for t in len_buckets:
                self.prefill([(scratch, True, np.zeros((t,), np.int32))] * bb,
                             sampling)
                runs += 1
            for t in chunk_buckets:
                self.prefill_chunk(
                    [(scratch, True, np.zeros((t,), np.int32))] * bb)
                runs += 1
            for k in sorted({1, *windows}):
                win = self.decode_window([scratch] * bb, [0] * bb, [k] * bb,
                                         sampling=sampling, window=k)
                self.fetch_window(win)
                runs += 1
            if self.draft is None:
                continue
            for t in sorted({*len_buckets, *chunk_buckets}):
                self.draft_prefill(
                    [(scratch, True, np.zeros((t,), np.int32))] * bb)
                runs += 1
            for k in sorted({k for k in spec_windows if k >= 1}):
                win = self.spec_window([scratch] * bb, [0] * bb,
                                       [k + 1] * bb, k_draft=k)
                self.fetch_window(win)
                runs += 1
        if self.tiers is not None:
            self.tiers.warmup_fills(self.max_batch)
        return runs

    # ---- session lifecycle (over the cache) --------------------------------

    def detach_session(self, session_id: str) -> DetachedState:
        with self._lock:
            return self.cache.detach(session_id)

    def restore_session(self, session_id: str, state: DetachedState) -> int:
        with self._lock:
            return self.cache.restore(session_id, state)

    def resident_models(self) -> dict[str, int]:
        """``{model_id: version}`` of the resident model (one here)."""
        return {self.model_id: self.model_version}

    def has_session(self, session_id: str) -> bool:
        """True when the session is in a device slot or restorable from a
        tier (host RAM, disk)."""
        if session_id in self.cache:
            return True
        return self.tiers is not None and self.tiers.has(session_id)

    def stats(self) -> dict:
        """The engine's counts. ``kernel_launches`` / ``reference_windows``
        (and the spec window's) count the window form this engine runs
        (``window_form``: float32, or bfloat16 under bf16 compute);
        ``launch_counts`` is every kernel counter of the process that
        launched, by name (the prefill's recurrence forwards too)."""
        with self._counts_lock:
            dispatches = dict(self.dispatches)
        wd = cuda_decode.layers_dtype(self.weights)
        dc = counts_of(wd, cuda_decode.counts, cuda_decode.counts_bf16)
        sc = counts_of(wd, cuda_spec.counts, cuda_spec.counts_bf16)
        return {
            "device": str(self.device),
            "decode_kernel": self.decode_kernel,
            "window_form": str(wd).removeprefix("torch."),
            "dispatches": dispatches,
            "kernel_launches": dc.kernel,
            "reference_windows": dc.reference,
            "has_draft": self.draft is not None,
            "spec_kernel_launches": sc.kernel,
            "spec_reference_windows": sc.reference,
            "launch_counts": {c.name: c.kernel
                              for c in LaunchCounts.every() if c.kernel},
            "cache": self.cache.stats(),
            "prefix_cache": None if self.prefix is None else self.prefix.stats(),
            "tiers": None if self.tiers is None else self.tiers.stats(),
            "prefill_buckets": list(self.prefill_buckets),
            "batch_buckets": list(self.batch_buckets),
        }
