"""Bidirectional LSTM sequence classifier (BASELINE.md config 2: IMDB
sentiment, hidden 256, sequences up to 400 tokens).

Port of ``lstm_tensorspark_tpu/models/classifier.py`` (float32). Each
bi-layer runs both directions through ``ops/scan.bidir_lstm_scan`` — on the
card one launch of the stacked-direction kernels, or two single-direction
scans with ``remat_chunk`` — with the carry-freeze mask, so the reverse
direction's final state is its state at t=0 over the valid prefix. The
directions' outputs concatenate to [B, T, 2H]; the head reads the concat of
both final states. Dropout (inverted) hits the inter-layer outputs and the
final [B, 2H] states when training. Params are a plain dict, as in the JAX
package::

    {"embedding": [V, E], "fwd": [LSTMParams, ...], "bwd": [...],
     "head": {"kernel": [2H, C], "bias": [C]}}
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from ..ops.embedding import embed_lookup
from ..ops.lstm_cell import LSTMParams, glorot_uniform, init_lstm_params
from ..ops.masking import dropout, dropout_with_keep, sequence_mask
from ..ops.scan import bidir_lstm_scan


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    vocab_size: int
    num_classes: int = 2
    hidden_size: int = 256
    num_layers: int = 1
    embed_size: int | None = None  # defaults to hidden_size
    dropout: float = 0.0
    # float32 only in this port; bf16 compute is a later slice
    compute_dtype: str = "float32"
    remat_chunk: int | None = None

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} is not supported by "
                "the port yet (float32 only)")

    @property
    def embed(self) -> int:
        return self.embed_size or self.hidden_size


def init_classifier(gen: torch.Generator, cfg: ClassifierConfig):
    """Parameter dict drawn on the CPU from ``gen``: embedding N(0, 0.02²),
    per layer the forward then the backward direction's cell init, a
    Glorot head and a zero bias."""
    embedding = torch.randn((cfg.vocab_size, cfg.embed), generator=gen,
                            dtype=torch.float32) * 0.02
    fwd, bwd = [], []
    for i in range(cfg.num_layers):
        in_size = cfg.embed if i == 0 else 2 * cfg.hidden_size
        fwd.append(init_lstm_params(gen, in_size, cfg.hidden_size))
        bwd.append(init_lstm_params(gen, in_size, cfg.hidden_size))
    head = {"kernel": glorot_uniform(gen, (2 * cfg.hidden_size,
                                           cfg.num_classes)),
            "bias": torch.zeros((cfg.num_classes,), dtype=torch.float32)}
    return {"embedding": embedding, "fwd": fwd, "bwd": bwd, "head": head}


def classifier_params_to(params, device) -> dict:
    """The classifier's parameter dict with every tensor on ``device``."""
    def layers(ls):
        return [LSTMParams(*(t.to(device) for t in layer)) for layer in ls]

    return {"embedding": params["embedding"].to(device),
            "fwd": layers(params["fwd"]), "bwd": layers(params["bwd"]),
            "head": {k: v.to(device) for k, v in params["head"].items()}}


def classifier_forward(params, tokens: torch.Tensor, lengths: torch.Tensor,
                       cfg: ClassifierConfig, *,
                       dropout_gen: torch.Generator | None = None,
                       dropout_keeps: Iterator[torch.Tensor] | None = None):
    """tokens [B, T] int, lengths [B] → logits [B, num_classes]. Dropout
    is on when ``cfg.dropout > 0`` and a source is given: keep masks drawn
    from ``dropout_gen``, or taken in order from ``dropout_keeps`` (the
    tests feed JAX's)."""
    training = cfg.dropout > 0.0 and (dropout_gen is not None
                                      or dropout_keeps is not None)

    def drop(x):
        if dropout_keeps is not None:
            return dropout_with_keep(next(dropout_keeps), cfg.dropout, x)
        return dropout(dropout_gen, cfg.dropout, x)

    mask = sequence_mask(lengths, tokens.shape[1])
    xs = embed_lookup(params["embedding"], tokens)
    h_fwd = h_bwd = None
    for i, (pf, pb) in enumerate(zip(params["fwd"], params["bwd"])):
        ((h_fwd, _), ys_f), ((h_bwd, _), ys_b) = bidir_lstm_scan(
            pf, pb, xs, mask=mask, remat_chunk=cfg.remat_chunk)
        xs = torch.cat([ys_f, ys_b], dim=-1)
        if i < cfg.num_layers - 1 and training:
            xs = drop(xs)
    final = torch.cat([h_fwd, h_bwd], dim=-1)  # [B, 2H]
    if training:
        final = drop(final)
    head = params["head"]
    return final @ head["kernel"] + head["bias"]


def classifier_loss(params, batch, cfg: ClassifierConfig, *,
                    dropout_gen: torch.Generator | None = None,
                    dropout_keeps: Iterator[torch.Tensor] | None = None):
    """batch: {"tokens" [B, T], "lengths" [B], "labels" [B], "valid" [B]}
    (valid optional). The mean softmax cross-entropy over valid rows;
    ``aux = {"loss", "accuracy"}`` (accuracy valid-weighted too)."""
    logits = classifier_forward(params, batch["tokens"], batch["lengths"],
                                cfg, dropout_gen=dropout_gen,
                                dropout_keeps=dropout_keeps)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = batch["labels"].to(torch.long)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    w = batch.get("valid")
    w = torch.ones_like(nll) if w is None else w.to(nll.dtype)
    denom = torch.clamp(w.sum(), min=1.0)
    loss = (nll * w).sum() / denom
    acc = ((torch.argmax(logits, dim=-1) == labels) * w).sum() / denom
    return loss, {"loss": loss, "accuracy": acc}
