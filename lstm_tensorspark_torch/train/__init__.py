"""Training: optax-matching optimizers, the train/eval steps and the host
loop, the K-step calls (host-fed and device-fed, with the fused eval),
their capture as CUDA graphs, and the metrics logger."""

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
from .device_step import make_device_lm_train_step, make_device_train_step
from .metrics import MetricsLogger
from .multistep import host_feed, make_multi_train_step
from .optimizer import make_optimizer

__all__ = ["AnomalousTrainingError", "MetricsLogger", "TrainState",
           "evaluate", "evaluate_classifier", "host_feed",
           "init_train_state",
           "make_device_lm_train_step", "make_device_train_step",
           "make_eval_step", "make_multi_train_step", "make_optimizer",
           "make_train_step", "train_loop"]
