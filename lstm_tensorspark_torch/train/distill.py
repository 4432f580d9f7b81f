"""Draft-model distillation for speculative serving.

Port of ``lstm_tensorspark_tpu/train/distill.py``. The speculative window
(``serve/engine.py::spec_window``) needs a draft LM that imitates the
target's next-token choices at a fraction of its step cost. This module
trains one: a small LM (:func:`draft_config`: H/4, one layer, the target's
vocabulary) fit to the target's logits over a corpus with a KL + CE loss
(:func:`make_distill_loss`), through the port's train plane
(``train/loop.py``'s step and loop, ``make_optimizer``).

The teacher's logits come from a batched scoring pass
(:func:`make_teacher_fn`), one forward a [B, T] window, computed as the
window is used and not kept: an epoch of [B, T, V] logits would dwarf the
draft. The teacher runs as JAX's does, a forward with no gradient whose
recurrence rounds as the plain scan does (on the card the forward kernels'
plain-rounding form, ``ops/scan.py``); the draft trains on the kernel
route, as ``cli train`` does.

Drafts publish through the model registry (``serve/registry.py``) as a
verified pair: the record's ``config_hash`` is the fingerprint of the
draft's config and ``parent`` is ``"<teacher_id>:<teacher fingerprint>"``.
:func:`load_draft` re-derives the draft's config from the teacher's and
refuses an artifact whose hashes disagree, so serving never pairs a draft
with a teacher it was not distilled from. The fingerprints are the JAX
package's, so a draft published by either package loads in the other.

Greedy speculative decoding emits the plain greedy sequence whatever the
draft's weights; distillation buys only accepted proposals.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from ..models.lstm_lm import LMConfig, init_lm, lm_forward, params_to
from ..serve.registry import ModelRegistry, config_fingerprint, encode_params
from .loop import device_batches, init_train_state, make_train_step, train_loop
from .optimizer import make_optimizer

#: the default draft shape relative to the target
DRAFT_HIDDEN_DIV = 4
DRAFT_NUM_LAYERS = 1


def draft_config(teacher_cfg: LMConfig, *,
                 hidden_div: int = DRAFT_HIDDEN_DIV,
                 num_layers: int = DRAFT_NUM_LAYERS) -> LMConfig:
    """The draft LM's config, derived deterministically from the target's:
    the same vocabulary (proposals must be target tokens) and head tying,
    hidden size ``H // hidden_div`` floored at 8, ``num_layers`` layers,
    the target's compute dtype. The derivation is the pairing contract:
    serving re-derives it from its target and checks the published draft's
    ``config_hash`` against it."""
    if hidden_div < 1:
        raise ValueError(f"hidden_div must be >= 1, got {hidden_div}")
    return LMConfig(
        vocab_size=teacher_cfg.vocab_size,
        hidden_size=max(8, teacher_cfg.hidden_size // hidden_div),
        num_layers=num_layers,
        tie_embeddings=teacher_cfg.tie_embeddings,
        compute_dtype=teacher_cfg.compute_dtype,
    )


def make_teacher_fn(teacher_params, teacher_cfg: LMConfig):
    """The batched scoring pass: inputs [B, T] (on the params' device) →
    the teacher's logits [B, T, V] float32, with no gradient. Dropout and
    ``remat_chunk`` are dropped (scoring is a plain forward), and the
    recurrence rounds as the plain scan does."""
    cfg = dataclasses.replace(teacher_cfg, dropout=0.0, remat_chunk=None)

    @torch.no_grad()
    def score(inputs: torch.Tensor) -> torch.Tensor:
        logits, _ = lm_forward(teacher_params, inputs, cfg,
                               plain_rounding=True)
        return logits.float()

    return score


def make_distill_loss(cfg: LMConfig, *, alpha: float = 0.5,
                      temperature: float = 2.0):
    """The KL + CE distillation loss for ``make_train_step``:
    ``loss_fn(params, batch) -> (loss, aux)`` over batches with
    ``inputs`` / ``targets`` [B, T] and ``teacher_logits`` [B, T, V].

    ``alpha`` weights KL(teacher ‖ student) at softmax temperature
    ``temperature``, scaled by temperature² (Hinton's scaling: the
    gradient's size does not depend on it); ``1 - alpha`` weights the
    cross-entropy on the corpus labels. ``aux`` holds ``loss``, ``kl``,
    ``ce`` and ``tokens``. The forward is deterministic: a draft's config
    (:func:`draft_config`) has no dropout."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    tau = float(temperature)

    def loss_fn(params, batch):
        logits, _ = lm_forward(params, batch["inputs"], cfg)
        logits = logits.float()
        # soft target: KL(teacher ‖ student) at temperature tau
        t_logp = torch.log_softmax(batch["teacher_logits"] / tau, dim=-1)
        s_logp = torch.log_softmax(logits / tau, dim=-1)
        kl = torch.mean(torch.sum(torch.exp(t_logp) * (t_logp - s_logp),
                                  dim=-1)) * tau * tau
        # hard target: next-token NLL on the corpus labels
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1,
                            batch["targets"][..., None].long())[..., 0]
        ce = torch.mean(nll)
        loss = alpha * kl + (1.0 - alpha) * ce
        aux = {"loss": loss, "kl": kl, "ce": ce,
               "tokens": float(batch["targets"].numel())}
        return loss, aux

    return loss_fn


def distill_batches(batches, teacher_fn):
    """An ``{"inputs", "targets"}`` batch stream with the teacher's logits
    added to each batch, scored as the batch is drawn."""
    for batch in batches:
        out = dict(batch)
        out["teacher_logits"] = teacher_fn(batch["inputs"])
        yield out


def distill(teacher_params, teacher_cfg: LMConfig, batches, *,
            num_steps: int, hidden_div: int = DRAFT_HIDDEN_DIV,
            num_layers: int = DRAFT_NUM_LAYERS, alpha: float = 0.5,
            temperature: float = 2.0, optimizer: str = "adam",
            learning_rate: float = 1e-3, seed: int = 0,
            log_every: int = 50, logger=None,
            device: str | torch.device = "cuda"):
    """Train a draft against ``teacher_params`` over an
    ``{"inputs", "targets"}`` stream of host batches, on ``device`` (each
    step eager: the teacher scores the batch, then the draft takes one
    optimizer step; one teacher forward a step). The draft's weights are
    drawn from ``seed``. Returns ``(draft_params, draft_cfg)`` with the
    params on the CPU."""
    dev = torch.device(device)
    dcfg = draft_config(teacher_cfg, hidden_div=hidden_div,
                        num_layers=num_layers)
    params = params_to(init_lm(torch.Generator().manual_seed(seed), dcfg),
                       dev)
    opt = make_optimizer(optimizer, learning_rate)
    state = init_train_state(params, opt)
    step = make_train_step(
        make_distill_loss(dcfg, alpha=alpha, temperature=temperature), opt,
        graph=False)
    teacher_fn = make_teacher_fn(params_to(teacher_params, dev), teacher_cfg)
    # the loop ends on the batch after the last step: cut the stream first,
    # so the teacher scores no window that no step uses
    feed = itertools.islice(device_batches(batches, dev), num_steps)
    state = train_loop(state, step, distill_batches(feed, teacher_fn),
                       num_steps=num_steps, log_every=log_every,
                       logger=logger)
    return params_to(state.params, "cpu"), dcfg


# ---- registry pairing ----------------------------------------------------


def draft_model_id(teacher_id: str) -> str:
    """The registry id a teacher's draft publishes under by default."""
    return f"{teacher_id}-draft"


def publish_draft(registry, draft_params, draft_cfg: LMConfig,
                  teacher_cfg: LMConfig, *, teacher_id: str = "default",
                  draft_id: str | None = None,
                  version: int | None = None) -> dict:
    """Publish a draft as the verified pair's record (module docstring):
    ``config_hash`` fingerprints the draft's config, ``parent`` names the
    teacher's id and fingerprint. ``registry`` is a
    :class:`~..serve.registry.ModelRegistry` or a directory."""
    if isinstance(registry, str):
        registry = ModelRegistry(registry)
    return registry.publish(
        draft_id or draft_model_id(teacher_id),
        encode_params(draft_params),
        version=version,
        config_hash=config_fingerprint(draft_cfg),
        parent=f"{teacher_id}:{config_fingerprint(teacher_cfg)}",
    )


def load_draft(registry, teacher_cfg: LMConfig, *,
               teacher_id: str = "default", draft_id: str | None = None,
               version: int | None = None):
    """Load a published draft for serving, verifying the pair: the draft's
    config is re-derived from ``teacher_cfg`` (:func:`draft_config`) and
    the artifact's ``config_hash`` must be its fingerprint; the record's
    ``parent`` must name ``teacher_id`` and ``teacher_cfg``'s fingerprint.
    Returns ``(meta, draft_params on the CPU, draft_cfg)``; raises
    ``ValueError`` on a mismatch."""
    if isinstance(registry, str):
        registry = ModelRegistry(registry)
    mid = draft_id or draft_model_id(teacher_id)
    dcfg = draft_config(teacher_cfg)
    want_hash = config_fingerprint(dcfg)
    meta = registry.meta(mid, version)
    if meta.get("config_hash") != want_hash:
        raise ValueError(
            f"draft {mid} v{meta['version']}: config_hash "
            f"{meta.get('config_hash')!r} does not match the derived "
            f"draft config {want_hash!r} (distilled for a different "
            "teacher shape, or with non-default draft dimensions)")
    want_parent = f"{teacher_id}:{config_fingerprint(teacher_cfg)}"
    if meta.get("parent") != want_parent:
        raise ValueError(
            f"draft {mid} v{meta['version']}: parent "
            f"{meta.get('parent')!r} does not match the serving teacher "
            f"{want_parent!r} — refusing the unverified pair")
    template = init_lm(torch.Generator().manual_seed(0), dcfg)
    meta, params = registry.load_params(mid, template, meta["version"])
    return meta, params, dcfg
