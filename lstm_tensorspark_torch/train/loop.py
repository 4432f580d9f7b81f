"""Train step, eval step and the host loop that drives them.

Port of the single-device, one-step-per-call part of
``lstm_tensorspark_tpu/train/loop.py``. A step is forward, backward
(``torch.autograd.grad``; on the card the recurrence's backward is the
fused BPTT kernel) and the optimizer update, all queued on the device: the
host reads nothing back unless the loop logs, evaluates, or watches for
anomalies.

Non-finite guard (as ``step_body``): when the loss or the gradient norm is
not finite, the step keeps the old params, optimizer state and carries —
chosen on the device with ``torch.where``, so the guard costs no host sync
— advances the step count, and reports ``anomalous = 1``.
``train_loop(anomaly_limit=K)`` raises :class:`AnomalousTrainingError`
after K consecutive anomalous steps.

Params are a model's dict (the LM's ``embedding``, ``layers``, ``head``;
the classifier's ``embedding``, ``fwd``, ``bwd``, ``head``); the optimizer
sees them as a flat list in the JAX pytree's leaf order
(:func:`param_leaves`).
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Iterable, NamedTuple

import numpy as np
import torch

from ..ops.lstm_cell import LSTMParams
from .optimizer import Optimizer, global_norm


class AnomalousTrainingError(RuntimeError):
    """Raised by :func:`train_loop` after ``anomaly_limit`` consecutive
    non-finite steps; the CLI maps it to ``exit_codes.ANOMALY_RC``."""

    def __init__(self, consecutive: int, total: int, step: int):
        self.consecutive = consecutive
        self.total = total
        self.step = step
        super().__init__(
            f"{consecutive} consecutive non-finite steps at step {step} "
            f"({total} anomalous total); aborting for supervisor restart")


class TrainState(NamedTuple):
    step: int  # optimizer steps taken (a host counter)
    params: Any
    opt_state: Any
    # per-layer (h, c) carried across contiguous windows (stateful truncated
    # BPTT); None for stateless training
    carries: Any = None


def param_leaves(params) -> list[torch.Tensor]:
    """The params as a flat list, in the JAX pytree's leaf order: dict
    keys sorted, lists and ``LSTMParams`` fields in order (the LM's
    embedding, head, layers; the classifier's bwd, embedding, fwd, head)."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in param_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in param_leaves(p)]
    return [params]


def params_from_leaves(like, leaves) -> Any:
    """Inverse of :func:`param_leaves` for params shaped like ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, LSTMParams):
            return LSTMParams(*(build(t) for t in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)

    return build(like)


def _map_state(fn, new, old):
    """``fn`` over matching tensors of two optimizer states."""
    out = {}
    for k, v in new.items():
        if isinstance(v, list):
            out[k] = [fn(a, b) for a, b in zip(v, old[k])]
        else:
            out[k] = fn(v, old[k])
    return out


def _detach_carries(carries):
    return [(h.detach(), c.detach()) for h, c in carries]


def init_train_state(params, optimizer: Optimizer, *, carries=None) -> TrainState:
    return TrainState(0, params, optimizer.init(param_leaves(params)), carries)


def call_loss(loss_fn, params, batch, carries, *, stateful: bool):
    """Uniform invocation of the (stateless|stateful) loss_fn signature."""
    if stateful:
        return loss_fn(params, batch, carries)
    return loss_fn(params, batch)


def step_body(loss_fn: Callable, optimizer: Optimizer, state: TrainState,
              batch, *, stateful: bool = False):
    """One optimizer step. ``loss_fn(params, batch[, carries]) -> (loss,
    aux)``; with ``stateful`` the loss's ``aux["carries"]`` (detached) seed
    the next window. Returns ``(new_state, metrics)`` with ``loss``,
    ``grad_norm`` and ``anomalous`` as device scalars."""
    old = param_leaves(state.params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in old]
        loss, aux = call_loss(loss_fn, params_from_leaves(state.params, live),
                              batch, state.carries, stateful=stateful)
        grads = torch.autograd.grad(loss, live)
    loss = loss.detach()
    carries = _detach_carries(aux["carries"]) if stateful else state.carries
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, state.opt_state, old)
        gnorm = global_norm(grads)
        # non-finite guard: keep params, moments and carries on a bad step
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)

        def keep(new, prev):
            return torch.where(finite, new, prev)

        new = [keep(p + u, p) for p, u in zip(old, updates)]
        opt_state = _map_state(keep, opt_state, state.opt_state)
        if stateful:
            carries = [(keep(h, h0), keep(c, c0))
                       for (h, c), (h0, c0) in zip(carries, state.carries)]
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "anomalous": (~finite).to(torch.float32)}
    return TrainState(state.step + 1, params_from_leaves(state.params, new),
                      opt_state, carries), metrics


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    stateful: bool = False):
    """``train_step(state, batch) -> (state, metrics)`` (see
    :func:`step_body`)."""

    def train_step(state: TrainState, batch):
        return step_body(loss_fn, optimizer, state, batch, stateful=stateful)

    return train_step


def make_eval_step(loss_fn: Callable, *, stateful: bool = False):
    """Forward-only step, under ``torch.no_grad`` (on the card the
    recurrence runs the forward kernel without residual writes). Stateful
    variant returns ``(metrics, carries)``."""

    def _metrics(loss, aux):
        m = {"loss": loss}
        if isinstance(aux, dict) and "tokens" in aux:
            m["tokens"] = aux["tokens"]
        return m

    if stateful:

        @torch.no_grad()
        def eval_step(params, batch, carries):
            loss, aux = loss_fn(params, batch, carries)
            return _metrics(loss, aux), aux["carries"]

    else:

        @torch.no_grad()
        def eval_step(params, batch):
            loss, aux = loss_fn(params, batch)
            return _metrics(loss, aux)

    return eval_step


def evaluate(eval_step, params, batches: Iterable, *, carries=None) -> dict:
    """Token-weighted mean loss and perplexity over ``batches``. Pass
    ``carries`` (with a stateful eval_step) to thread recurrent state
    through the contiguous stream. The losses are read back once, after
    the last batch is queued."""
    stateful = carries is not None
    handles = []
    for batch in batches:
        if stateful:
            m, carries = eval_step(params, batch, carries)
        else:
            m = eval_step(params, batch)
        handles.append(m)
    if not handles:
        return eval_metrics(0.0)
    losses = torch.stack([m["loss"] for m in handles]).cpu().tolist()
    total, weight = 0.0, 0.0
    for m, loss in zip(handles, losses):
        w = float(m.get("tokens", 1.0))
        total += loss * w
        weight += w
    return eval_metrics(total / max(weight, 1.0))


def evaluate_classifier(eval_step, params, batches: Iterable) -> dict:
    """``eval_loss`` and ``eval_accuracy`` over ``batches``, each batch's
    metrics weighted by its valid rows (filler rows count for nothing).
    ``eval_step(params, batch)`` returns {"loss", "accuracy"}; everything
    is read back once, after the last batch is queued."""
    rows = []
    for batch in batches:
        m = eval_step(params, batch)
        rows.append(torch.stack([m["loss"], m["accuracy"],
                                 batch["valid"].sum().to(torch.float32)]))
    if not rows:
        return {"eval_skipped": 1}
    tot_loss = tot_acc = tot_w = 0.0
    for loss, acc, w in torch.stack(rows).cpu().tolist():
        tot_loss += loss * w
        tot_acc += acc * w
        tot_w += w
    tot_w = max(tot_w, 1.0)
    return {"eval_loss": tot_loss / tot_w, "eval_accuracy": tot_acc / tot_w}


def eval_metrics(loss: float) -> dict:
    """Loss → the eval record's metrics (perplexity capped at exp(30))."""
    loss = float(loss)
    return {"eval_loss": loss, "eval_ppl": math.exp(min(loss, 30.0))}


def device_batches(batches: Iterable[dict], device) -> Iterable[dict]:
    """Host numpy batches → tensors on ``device``. On the card each array
    goes through pinned memory and is copied without blocking the host, in
    stream order before the step that reads it."""
    dev = torch.device(device)
    for batch in batches:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            out[k] = t
        yield out


def train_loop(state: TrainState, train_step: Callable, batches: Iterable, *,
               num_steps: int | None = None, log_every: int = 50,
               logger=None, eval_fn: Callable[[Any], dict] | None = None,
               eval_every: int = 0, tokens_per_batch: int | None = None,
               examples_per_batch: int | None = None,
               anomaly_limit: int = 0,
               best_metric: str | None = None) -> TrainState:
    """Drive ``train_step`` over ``batches``, logging every ``log_every``
    steps (loss, grad_norm, steps_per_sec, tokens_per_sec and
    examples_per_sec when given per batch) and calling ``eval_fn(params)``
    every ``eval_every`` steps. With ``best_metric`` (higher is better,
    e.g. ``eval_accuracy``), an eval that raises it (NaN never counts) is
    logged as a ``new best`` record.

    Reading the logged loss is the only host sync of a logged step; with
    ``anomaly_limit=K`` (off at 0) every step's ``anomalous`` flag is read
    too, and K consecutive anomalous steps raise
    :class:`AnomalousTrainingError`."""
    if num_steps is not None and num_steps <= 0:
        return state  # eval-only budget: never pull a batch from the feed
    window_start = time.perf_counter()
    last_metrics = None
    anomalous_total = 0
    anomalous_consec = 0
    best = None
    for i, batch in enumerate(batches):
        if num_steps is not None and i >= num_steps:
            break
        step = i + 1
        state, metrics = train_step(state, batch)
        last_metrics = metrics
        if anomaly_limit:
            bad = int(metrics["anomalous"].item())  # sync point (documented)
            anomalous_total += bad
            anomalous_consec = anomalous_consec + 1 if bad else 0
            if anomalous_consec >= anomaly_limit:
                if logger is not None:
                    logger.log({"step": state.step, "note": "anomaly abort",
                                "anomalous_steps": anomalous_total,
                                "anomalous_consecutive": anomalous_consec})
                raise AnomalousTrainingError(anomalous_consec,
                                             anomalous_total, state.step)
        if log_every and step % log_every == 0:
            loss = float(metrics["loss"].item())  # sync point
            now = time.perf_counter()
            dt = now - window_start
            window_start = now
            record = {"step": state.step, "loss": loss,
                      "grad_norm": float(metrics["grad_norm"].item()),
                      "steps_per_sec": log_every / dt}
            if anomaly_limit:
                if anomalous_total:
                    record["anomalous_steps"] = anomalous_total
            else:
                bad = float(metrics["anomalous"].item())
                if bad:
                    record["anomalous"] = bad
            if tokens_per_batch:
                record["tokens_per_sec"] = tokens_per_batch * log_every / dt
            if examples_per_batch:
                record["examples_per_sec"] = (examples_per_batch * log_every
                                              / dt)
            if logger is not None:
                logger.log(record)
        if eval_every and step % eval_every == 0 and eval_fn is not None:
            ev = eval_fn(state.params)
            if logger is not None:
                logger.log({"step": state.step, **ev})
            v = ev.get(best_metric) if best_metric else None
            if v is not None and v == v and (best is None or v > best):
                best = v
                if logger is not None:
                    logger.log({"step": state.step,
                                "note": f"new best {best_metric}",
                                best_metric: v})
            # the eval's time is not training throughput
            window_start = time.perf_counter()
    if last_metrics is not None:
        last_metrics["loss"].item()  # the last queued step has finished
    return state
