"""Autoregressive generation for the LSTM LM (plain PyTorch).

Port of ``lstm_tensorspark_tpu/models/generate.py``: greedy argmax,
temperature scaling, top-k truncation and top-p (nucleus) truncation, with
JAX's semantics. Sampling is the Gumbel-argmax identity behind
``jax.random.categorical``: ``argmax(truncated logits / max(t, 1e-6) +
g)`` with ``g`` Gumbel noise — either given by the caller (tests hand both
packages the draws of ``jax.random.gumbel``) or drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..ops.embedding import embed_lookup
from ..ops.lstm_cell import fuse_params, lstm_step
from .lstm_lm import (LMConfig, _head_kernel, head_logits, init_carries,
                      lm_forward, params_to)


def check_sampling(temperature: float = 1.0, top_k=None, top_p=None,
                   greedy: bool = False) -> None:
    """Raise ``ValueError`` for what JAX's ``sample_logits`` refuses:
    ``top_k < 1``, or ``top_p`` outside (0, 1]. Greedy ignores the other
    fields, as in the JAX package."""
    if greedy:
        return
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def gumbel_noise(shape, *, generator: torch.Generator | None = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in (tiny, 1) —
    the form ``jax.random.gumbel`` uses."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def truncate_logits(logits: torch.Tensor, top_k=None,
                    top_p=None) -> torch.Tensor:
    """JAX's truncation: logits below the k-th largest become -inf, then
    those outside the nucleus — the tokens whose exclusive cumulative
    mass, in descending order, is < ``top_p`` stay (the top token always
    does)."""
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p is not None and top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        cutoff = torch.where(keep, desc, torch.inf).amin(dim=-1,
                                                         keepdim=True)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def sample_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                  top_k=None, top_p=None, greedy: bool = False,
                  noise: torch.Tensor | None = None,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Token ids [B] int32 from logits [B, V]: argmax when ``greedy``, else
    Gumbel-argmax over the scaled, truncated logits (``noise`` [B, V], or
    drawn from ``generator``). Ties break to the lowest index
    (``torch.argmax`` and ``jnp.argmax`` agree on that)."""
    check_sampling(temperature, top_k, top_p, greedy)
    logits = logits.float()
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if temperature != 1.0:
        # a tensor divisor gives true division on every device (a Python
        # scalar divisor may become a reciprocal multiply on the card)
        logits = logits / torch.full((), max(temperature, 1e-6),
                                     dtype=torch.float32, device=logits.device)
    logits = truncate_logits(logits, top_k, top_p)
    if noise is None:
        noise = gumbel_noise(logits.shape, generator=generator,
                             device=logits.device)
    return torch.argmax(noise + logits, dim=-1).to(torch.int32)


def fuse_layers(params, cfg: LMConfig):
    """Fuse every layer's gate matrices once (outside the decode loop), in
    the config's compute dtype (float32 without a config)."""
    cd = None if cfg is None or cfg.cdtype == torch.float32 else cfg.cdtype
    return [fuse_params(layer, compute_dtype=cd) for layer in params["layers"]]


def decode_one(params, fused_layers, cfg: LMConfig, carries, token):
    """One decode step: token [B] → (logits [B, V], new carries)."""
    x = embed_lookup(params["embedding"], token)
    new_carries = []
    for fused, carry in zip(fused_layers, carries):
        carry, x = lstm_step(fused, carry, x)
        new_carries.append(carry)
    kernel, bias = _head_kernel(params, cfg)
    # the prefill's logits dtype, so a decode step samples as lm_forward's
    # last position does
    return head_logits(x, kernel, bias, cfg), new_carries


@torch.no_grad()
def generate(params, prompt, cfg: LMConfig, *, max_new_tokens: int,
             temperature: float = 1.0, top_k=None, top_p=None,
             greedy: bool = False, generator: torch.Generator | None = None,
             noise: torch.Tensor | None = None,
             device: str | torch.device = "cuda") -> torch.Tensor:
    """prompt [B, T0] int → [B, T0 + N] int32 on ``device``. Sampling
    draws its Gumbel noise from ``generator`` (a generator on ``device``),
    one [B, V] draw a token, unless ``noise`` [N, B, V] gives the draws
    (the tests feed JAX's). Params are moved to ``device`` first.
    """
    check_sampling(temperature, top_k, top_p, greedy)
    # inference never rematerialises: remat_chunk is a training-memory
    # device and would refuse prompt lengths it does not divide
    if cfg.remat_chunk is not None:
        cfg = dataclasses.replace(cfg, remat_chunk=None)
    dev = resolve_device(device)
    params = params_to(params, dev)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    B = prompt.shape[0]

    def sample(logits, i):
        return sample_logits(
            logits, temperature=temperature, top_k=top_k, top_p=top_p,
            greedy=greedy, generator=generator,
            noise=None if noise is None or greedy else noise[i].to(dev))

    logits, carries = lm_forward(params, prompt, cfg,
                                 carries=init_carries(cfg, B, device=dev))
    token = sample(logits[:, -1, :], 0)
    fused = fuse_layers(params, cfg)
    out = [token]
    for i in range(1, max_new_tokens):
        logits, carries = decode_one(params, fused, cfg, carries, token)
        token = sample(logits, i)
        out.append(token)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
