"""Vocabulary indexing: the embedding row gather and the target-logit pick.

Port of ``lstm_tensorspark_tpu/ops/embedding.py``. The forward is the row
gather. Its gradient sums each row's cotangents in an order fixed by the
inputs alone, so two runs of one command give the same bits on the card
(a run resumed from a checkpoint repeats the uninterrupted run's losses,
``train/checkpoint.py``), where autograd's ``index_select`` backward
(``index_add_``) adds them by atomics in an order that changes from run
to run. As the JAX package does, at V <= ``MM_GRAD_MAX_V`` the gradient is
the one-hot contraction ``one_hot(tokens)ᵀ @ g`` (a float32 matmul; the
0/1 factor makes every product exact) and above it a scatter-add,
``index_put_(..., accumulate=True)`` (sorted by row, a stable sort), where
the [N, V] one-hot factor would cost more than the scatter.
``selected_logits`` is a gather whose gradient writes one cotangent per
position, bit-equal to the one-hot form.
"""

from __future__ import annotations

import torch

#: the largest vocabulary whose embedding gradient is the one-hot matmul
#: (JAX ``ops/embedding._MM_GRAD_MAX_V``)
MM_GRAD_MAX_V = 2048


class _RowGather(torch.autograd.Function):
    """``embedding.index_select(0, flat)`` with a gradient summed in a
    fixed order (the module docstring)."""

    @staticmethod
    def forward(ctx, embedding, flat):
        ctx.save_for_backward(flat)
        ctx.rows = embedding.shape
        return embedding.index_select(0, flat)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        V = ctx.rows[0]
        if V <= MM_GRAD_MAX_V:
            onehot = (flat[:, None] == torch.arange(V, device=flat.device)
                      ).to(g.dtype)
            return onehot.T @ g, None
        grad = g.new_zeros(ctx.rows).index_put_((flat,), g, accumulate=True)
        return grad, None


def embed_lookup(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embedding[tokens]``: tokens of any shape → ``[*tokens.shape, E]``."""
    flat = tokens.reshape(-1).to(torch.long)
    return _RowGather.apply(embedding, flat).reshape(*tokens.shape,
                                                     embedding.shape[1])


def selected_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logits[..., targets]`` over the trailing vocab axis; ``targets``
    has logits' shape minus the last axis."""
    idx = targets.to(torch.long).unsqueeze(-1)
    return torch.gather(logits, -1, idx).squeeze(-1)
