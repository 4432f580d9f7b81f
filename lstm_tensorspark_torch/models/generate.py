"""Autoregressive generation for the LSTM LM (plain PyTorch).

Port of ``lstm_tensorspark_tpu/models/generate.py`` for greedy and
temperature sampling. Temperature sampling is the Gumbel-argmax identity
``argmax(logits / max(t, 1e-6) + g)`` with ``g`` Gumbel noise — either
given by the caller (tests hand both packages the same numpy draw) or
drawn from an explicit ``torch.Generator``. Top-k and top-p are refused.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.cuda_decode import sampling_supported
from ..ops.embedding import embed_lookup
from ..ops.lstm_cell import fuse_params, lstm_step
from .lstm_lm import LMConfig, _head_kernel, init_carries, lm_forward, params_to


def check_sampling(temperature: float = 1.0, top_k=None, top_p=None,
                   greedy: bool = False) -> None:
    """Raise ``ValueError`` for a sampling config the port does not serve:
    greedy and pure temperature sampling only (top-k / top-p truncation is
    not ported yet). Greedy ignores the other fields, as in the JAX
    package."""
    if not sampling_supported(temperature, top_k, top_p, greedy):
        raise ValueError(
            "top-k / top-p sampling is not supported by the PyTorch port "
            "(greedy and temperature sampling only)")


def gumbel_noise(shape, *, generator: torch.Generator | None = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in (tiny, 1) —
    the form ``jax.random.gumbel`` uses."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                  top_k=None, top_p=None, greedy: bool = False,
                  noise: torch.Tensor | None = None,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Token ids [B] int32 from logits [B, V]. Ties break to the lowest
    index (``torch.argmax`` and ``jnp.argmax`` agree on that)."""
    check_sampling(temperature, top_k, top_p, greedy)
    logits = logits.float()
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if temperature != 1.0:
        # a tensor divisor gives true division on every device (a Python
        # scalar divisor may become a reciprocal multiply on the card)
        logits = logits / torch.full((), max(temperature, 1e-6),
                                     dtype=torch.float32, device=logits.device)
    if noise is None:
        noise = gumbel_noise(logits.shape, generator=generator,
                             device=logits.device)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def fuse_layers(params, cfg: LMConfig):
    """Fuse every layer's gate matrices once (outside the decode loop)."""
    return [fuse_params(layer) for layer in params["layers"]]


def decode_one(params, fused_layers, cfg: LMConfig, carries, token):
    """One decode step: token [B] → (logits [B, V], new carries)."""
    x = embed_lookup(params["embedding"], token)
    new_carries = []
    for fused, carry in zip(fused_layers, carries):
        carry, x = lstm_step(fused, carry, x)
        new_carries.append(carry)
    kernel, bias = _head_kernel(params, cfg)
    return x @ kernel + bias, new_carries


@torch.no_grad()
def generate(params, prompt, cfg: LMConfig, *, max_new_tokens: int,
             temperature: float = 1.0, top_k=None, top_p=None,
             greedy: bool = False, generator: torch.Generator | None = None,
             device: str | torch.device = "cuda") -> torch.Tensor:
    """prompt [B, T0] int → [B, T0 + N] int32 on ``device``. Temperature
    sampling draws its Gumbel noise from ``generator`` (a generator on
    ``device``). Params are moved to ``device`` first.
    """
    check_sampling(temperature, top_k, top_p, greedy)
    dev = resolve_device(device)
    params = params_to(params, dev)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    B = prompt.shape[0]

    def sample(logits):
        return sample_logits(logits, temperature=temperature, greedy=greedy,
                             generator=generator)

    logits, carries = lm_forward(params, prompt, cfg,
                                 carries=init_carries(cfg, B, device=dev))
    token = sample(logits[:, -1, :])
    fused = fuse_layers(params, cfg)
    out = [token]
    for _ in range(1, max_new_tokens):
        logits, carries = decode_one(params, fused, cfg, carries, token)
        token = sample(logits)
        out.append(token)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
