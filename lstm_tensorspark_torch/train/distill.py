"""The draft LM's shape for speculative serving.

Port of the serving half of ``lstm_tensorspark_tpu/train/distill.py``:
:func:`draft_config` derives the draft's config from the target's, the one
definition the serve CLI and the tests share. The training half (the
teacher's scoring pass, the KL+CE distillation loss, its batch stream, the
``distill`` loop and ``cli distill``) and the registry pairing
(``publish_draft``/``load_draft``) are not ported yet; the port's serve CLI
draws the draft's weights from a seed.

Greedy speculative decoding emits the plain greedy sequence whatever the
draft's weights, so a draft that was never distilled is correct, only
slower (fewer of its proposals are accepted).
"""

from __future__ import annotations

from ..models.lstm_lm import LMConfig

#: the default draft shape relative to the target
DRAFT_HIDDEN_DIV = 4
DRAFT_NUM_LAYERS = 1


def draft_config(teacher_cfg: LMConfig, *,
                 hidden_div: int = DRAFT_HIDDEN_DIV,
                 num_layers: int = DRAFT_NUM_LAYERS) -> LMConfig:
    """The draft LM's config, derived deterministically from the target's:
    the same vocabulary (proposals must be target tokens) and head tying,
    hidden size ``H // hidden_div`` floored at 8, ``num_layers`` layers,
    the target's compute dtype."""
    if hidden_div < 1:
        raise ValueError(f"hidden_div must be >= 1, got {hidden_div}")
    return LMConfig(
        vocab_size=teacher_cfg.vocab_size,
        hidden_size=max(8, teacher_cfg.hidden_size // hidden_div),
        num_layers=num_layers,
        tie_embeddings=teacher_cfg.tie_embeddings,
        compute_dtype=teacher_cfg.compute_dtype,
    )
