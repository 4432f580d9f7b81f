"""Training: optax-matching optimizers, the train/eval steps and the host
loop, and the metrics logger."""

from .loop import (
    AnomalousTrainingError,
    TrainState,
    evaluate,
    evaluate_classifier,
    init_train_state,
    make_eval_step,
    make_train_step,
    train_loop,
)
from .metrics import MetricsLogger
from .optimizer import make_optimizer

__all__ = ["AnomalousTrainingError", "MetricsLogger", "TrainState",
           "evaluate", "evaluate_classifier", "init_train_state", "make_eval_step",
           "make_optimizer", "make_train_step", "train_loop"]
