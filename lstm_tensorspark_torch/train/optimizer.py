"""Optimizers with optax's update math, on plain tensors.

Port of ``lstm_tensorspark_tpu/train/optimizer.py::make_optimizer``: an
optional global-norm clip, then SGD (± momentum), momentum, Adam, AdamW or
RMSProp, then the learning rate (a constant, a linear warmup that holds,
or a linear warmup into a cosine decay). The math follows optax 0.2 step
for step — not ``torch.optim``, which differs (optax's rmsprop, for one,
decays at 0.9 and adds eps inside the square root).

An optimizer works on a flat list of parameter tensors. Its state is a
dict of tensors and tensor lists (``count`` an int32 scalar, the moments
one tensor per parameter), kept on the parameters' device; ``update``
makes no host sync, so a train step stays asynchronous.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]

OPTIMIZERS = ("sgd", "momentum", "adam", "adamw", "rmsprop")


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, new_state)``; apply with ``p + u`` (optax's
    ``apply_updates``)."""

    init: Callable
    update: Callable


# --- schedules (optax.schedules, on an int32 step-count tensor) -----------


def constant_schedule(value: float) -> Schedule:
    return lambda count: torch.full((), value, dtype=torch.float32,
                                    device=count.device)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        c = torch.clamp(count, 0, transition_steps).to(torch.float32)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0, exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got {decay_steps}")

    def schedule(count):
        c = torch.clamp(count.to(torch.float32), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def join_schedules(schedules, boundaries) -> Schedule:
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, sched(count - boundary))
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)],
        [warmup_steps])


# --- transforms ------------------------------------------------------------


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def _clip(grads, max_norm: float):
    g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    return 1 - decay ** count.to(torch.float32)


def make_optimizer(name: str = "sgd", learning_rate: float = 1.0, *,
                   momentum: float = 0.0, clip_norm: float | None = None,
                   weight_decay: float = 0.0, warmup_steps: int = 0,
                   decay_steps: int | None = None) -> Optimizer:
    """[clip] -> optimizer [-> weight decay] -> learning rate, as the JAX
    package's optax chain."""
    if decay_steps is not None:
        schedule = warmup_cosine_decay_schedule(
            init_value=0.0 if warmup_steps > 0 else learning_rate,
            peak_value=learning_rate,
            warmup_steps=max(warmup_steps, 1),
            decay_steps=max(decay_steps, warmup_steps + 1),
            end_value=learning_rate * 0.1)
    elif warmup_steps > 0:
        # warmup with no decay horizon: ramp to peak, then hold at peak
        schedule = join_schedules(
            [linear_schedule(0.0, learning_rate, warmup_steps),
             constant_schedule(learning_rate)], [warmup_steps])
    else:
        schedule = None

    name = name.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}")
    trace_decay = None
    if name == "sgd" and momentum > 0:
        trace_decay = momentum
    elif name == "momentum":
        trace_decay = momentum or 0.9
    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam / adamw defaults
    rms_decay = 0.9  # optax.rmsprop default

    def init(params):
        zeros = [torch.zeros_like(p) for p in params]
        dev = params[0].device
        state = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
        if trace_decay is not None:
            state["trace"] = zeros
        if name in ("adam", "adamw"):
            state["mu"] = zeros
            state["nu"] = [torch.zeros_like(p) for p in params]
        if name == "rmsprop":
            state["nu"] = zeros
        return state

    def update(grads, state, params):
        new = {"count": state["count"] + 1}
        g = list(grads)
        if clip_norm is not None:
            g = _clip(g, clip_norm)
        if trace_decay is not None:
            g = [gi + trace_decay * t for gi, t in zip(g, state["trace"])]
            new["trace"] = g
        if name in ("adam", "adamw"):
            mu = [(1 - b1) * gi + b1 * m for gi, m in zip(g, state["mu"])]
            nu = [(1 - b2) * (gi * gi) + b2 * v for gi, v in zip(g, state["nu"])]
            bc1 = _bias_correction(b1, new["count"])
            bc2 = _bias_correction(b2, new["count"])
            g = [(m / bc1) / (torch.sqrt(v / bc2) + eps) for m, v in zip(mu, nu)]
            new["mu"], new["nu"] = mu, nu
            if name == "adamw":
                g = [gi + weight_decay * p for gi, p in zip(g, params)]
        if name == "rmsprop":
            nu = [(1 - rms_decay) * (gi * gi) + rms_decay * v
                  for gi, v in zip(g, state["nu"])]
            g = [torch.rsqrt(v + eps) * gi for gi, v in zip(g, nu)]
            new["nu"] = nu
        if schedule is None:
            updates = [(-learning_rate) * gi for gi in g]
        else:
            step_size = -schedule(state["count"])
            updates = [step_size * gi for gi in g]
        return updates, new

    return Optimizer(init, update)
