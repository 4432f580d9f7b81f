"""Embedding lookup (forward only): a plain row gather.

Port of ``lstm_tensorspark_tpu/ops/embedding.py::embed_lookup``. The JAX
package keeps the forward a row gather and changes only the gradient at
small vocabularies (a TPU profiling choice); serving needs the forward
alone, which is bit-identical either way.
"""

from __future__ import annotations

import torch


def embed_lookup(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embedding[tokens]``: tokens of any shape → ``[*tokens.shape, E]``."""
    flat = tokens.reshape(-1).to(torch.long)
    return embedding.index_select(0, flat).reshape(*tokens.shape,
                                                   embedding.shape[1])
