"""LSTM language model: embedding → stacked LSTM → linear head.

Port of ``lstm_tensorspark_tpu/models/lstm_lm.py`` (float32): the forward,
and :func:`lm_loss`, the next-token cross-entropy that training
differentiates, with dropout between layers. The recurrence goes through
``ops/scan.stacked_lstm_scan``, so on the card every layer runs the
hand-written recurrence kernels and on the CPU the plain loop. Params are a plain dict, as in the JAX package::

    {"embedding": [V, E],
     "layers": [LSTMParams, ...],
     "head": {"kernel": [H, V], "bias": [V]}}   # untied
     "head": {"bias": [V]}                       # tied: kernel = embedding.T
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from ..ops.embedding import embed_lookup, selected_logits
from ..ops.lstm_cell import LSTMParams, glorot_uniform, init_lstm_params, zero_carry
from ..ops.scan import stacked_lstm_scan


# At this vocab size the JAX lm_loss switches to the vocab-chunked
# cross-entropy (ops/xent.py), which is not ported yet.
_CHUNKED_XENT_MIN_V = 2**17


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int
    hidden_size: int = 128
    num_layers: int = 1
    embed_size: int | None = None  # defaults to hidden_size
    tie_embeddings: bool = False
    # float32 only in this port; bf16 compute is a later slice
    compute_dtype: str = "float32"
    # checkpoint chunks of the recurrence; the backward recomputes them
    remat_chunk: int | None = None
    # inverted dropout between layers (training only: it needs a source of
    # keep masks, see lm_backbone)
    dropout: float = 0.0

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} is not supported by "
                "the port yet (float32 only)")
        if self.tie_embeddings and self.embed != self.hidden_size:
            raise ValueError("tie_embeddings requires embed_size == hidden_size")

    @property
    def embed(self) -> int:
        return self.embed_size or self.hidden_size


def init_lm(gen: torch.Generator, cfg: LMConfig):
    """Parameter dict drawn on the CPU from ``gen`` (a CPU generator):
    embedding N(0, 0.02²), per-layer cell init, Glorot head, zero bias."""
    embedding = torch.randn((cfg.vocab_size, cfg.embed), generator=gen,
                            dtype=torch.float32) * 0.02
    layers = [
        init_lstm_params(gen, cfg.embed if i == 0 else cfg.hidden_size,
                         cfg.hidden_size)
        for i in range(cfg.num_layers)
    ]
    params = {"embedding": embedding, "layers": layers}
    head = {"bias": torch.zeros((cfg.vocab_size,), dtype=torch.float32)}
    if not cfg.tie_embeddings:
        head["kernel"] = glorot_uniform(gen, (cfg.hidden_size, cfg.vocab_size))
    params["head"] = head
    return params


def params_to(params, device) -> dict:
    """The parameter dict with every tensor on ``device``."""
    return {
        "embedding": params["embedding"].to(device),
        "layers": [LSTMParams(*(t.to(device) for t in layer))
                   for layer in params["layers"]],
        "head": {k: v.to(device) for k, v in params["head"].items()},
    }


def init_carries(cfg: LMConfig, batch: int, device=None):
    return [zero_carry(batch, cfg.hidden_size, device=device)
            for _ in range(cfg.num_layers)]


def lm_backbone(params, tokens: torch.Tensor, cfg: LMConfig, *,
                carries=None, mask: torch.Tensor | None = None,
                dropout_gen: torch.Generator | None = None,
                dropout_keeps: Iterator[torch.Tensor] | None = None):
    """tokens [B, T] → (per-layer final carries, top-layer activations
    [B, T, H]). ``mask`` [B, T] bool freezes the carries at False steps.
    Dropout (``cfg.dropout``, between layers) is on only when a source of
    keep masks is given: drawn from ``dropout_gen``, or taken in order from
    ``dropout_keeps`` (the tests feed JAX's); without one the pass is
    deterministic, as eval is."""
    xs = embed_lookup(params["embedding"], tokens)
    return stacked_lstm_scan(params["layers"], xs, carries, mask=mask,
                             remat_chunk=cfg.remat_chunk,
                             dropout_rate=cfg.dropout,
                             dropout_gen=dropout_gen,
                             dropout_keeps=dropout_keeps)


def _head_kernel(params, cfg: LMConfig):
    head = params["head"]
    kernel = params["embedding"].T if cfg.tie_embeddings else head["kernel"]
    return kernel, head["bias"]


def lm_forward(params, tokens: torch.Tensor, cfg: LMConfig, *, carries=None,
               dropout_gen: torch.Generator | None = None,
               dropout_keeps: Iterator[torch.Tensor] | None = None):
    """tokens [B, T] → (logits [B, T, V], final per-layer carries)."""
    finals, ys = lm_backbone(params, tokens, cfg, carries=carries,
                             dropout_gen=dropout_gen,
                             dropout_keeps=dropout_keeps)
    kernel, bias = _head_kernel(params, cfg)
    return ys @ kernel + bias, finals


def lm_loss(params, batch, cfg: LMConfig, *, carries=None,
            dropout_gen: torch.Generator | None = None,
            dropout_keeps: Iterator[torch.Tensor] | None = None):
    """Next-token cross-entropy, the mean over B*T tokens of
    ``logsumexp(logits) - logits[target]``.

    ``batch``: dict with "inputs" and "targets" [B, T] integer tensors.
    Returns ``(loss, aux)`` with ``aux = {"loss", "tokens", "carries"}``
    (``tokens`` a host float; ``carries`` the final per-layer (h, c), still
    attached to the graph). ``dropout_gen`` / ``dropout_keeps``: as in
    :func:`lm_backbone`.
    """
    if cfg.vocab_size >= _CHUNKED_XENT_MIN_V:
        raise NotImplementedError(
            f"vocab {cfg.vocab_size} >= {_CHUNKED_XENT_MIN_V} takes the "
            "vocab-chunked cross-entropy in the JAX package; chunked xent "
            "is not ported yet")
    logits, finals = lm_forward(params, batch["inputs"], cfg, carries=carries,
                                dropout_gen=dropout_gen,
                                dropout_keeps=dropout_keeps)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = selected_logits(logits, batch["targets"])
    loss = torch.mean(lse - tgt)
    aux = {
        "loss": loss,
        "tokens": float(batch["targets"].numel()),
        "carries": finals,
    }
    return loss, aux
