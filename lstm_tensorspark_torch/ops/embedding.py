"""Vocabulary indexing: the embedding row gather and the target-logit pick.

Port of ``lstm_tensorspark_tpu/ops/embedding.py``. The JAX package keeps
the forward a row gather and, at V <= 2048, computes the embedding
gradient as a one-hot matmul and the target logit as a one-hot
multiply-reduce — choices a TPU profile made. Here both are the plain
operations: the gradient of ``embed_lookup`` is autograd's scatter-add of
the row gather (``index_select``'s backward), equal to the one-hot
contraction up to float32 summation order, and ``selected_logits`` is a
gather whose gradient writes one cotangent per position, bit-equal to the
one-hot form.
"""

from __future__ import annotations

import torch


def embed_lookup(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embedding[tokens]``: tokens of any shape → ``[*tokens.shape, E]``."""
    flat = tokens.reshape(-1).to(torch.long)
    return embedding.index_select(0, flat).reshape(*tokens.shape,
                                                   embedding.shape[1])


def selected_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logits[..., targets]`` over the trailing vocab axis; ``targets``
    has logits' shape minus the last axis."""
    idx = targets.to(torch.long).unsqueeze(-1)
    return torch.gather(logits, -1, idx).squeeze(-1)
