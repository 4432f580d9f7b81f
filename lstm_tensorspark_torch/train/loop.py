"""Train step, eval step and the host loop that drives them.

Port of the single-device part of ``lstm_tensorspark_tpu/train/loop.py``.
A step is forward, backward (``torch.autograd.grad``; on the card the
recurrence's backward is the fused BPTT kernel) and the optimizer update,
all queued on the device: the host reads nothing back unless the loop
logs, evaluates, or watches for anomalies. On the card a train step is
captured as a CUDA graph and replayed (``train/graphs.py``); K steps a
call are ``train/multistep.py`` and ``train/device_step.py``, whose
calls this loop drives too (``steps_per_call``).

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

Checkpoints (``train/checkpoint.py``): :func:`checkpoint_state` is the dict
a run's state is saved as, :func:`restore_state` its inverse onto a fresh
run's state; ``train_loop(checkpoint_fn=, checkpoint_every=)`` saves every
``checkpoint_every`` calls, as JAX's loop does.
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


def checkpoint_state(state: TrainState, generators=()) -> dict:
    """What a checkpoint of ``state`` holds (``train/checkpoint.py``): the
    step, the params' leaves (:func:`param_leaves` order), the optimizer
    state, the carries, the states of ``generators`` (the run's dropout
    generators, in the caller's order) and the data cursor ``start_step``
    (the optimizer steps the feed has served: the step)."""
    return {"step": int(state.step), "params": param_leaves(state.params),
            "opt_state": state.opt_state,
            "carries": (None if state.carries is None
                        else [[h, c] for h, c in state.carries]),
            "generators": [g.get_state() for g in generators],
            "start_step": int(state.step)}


def _match(what: str, saved, like) -> torch.Tensor:
    if not isinstance(saved, torch.Tensor) or saved.shape != like.shape \
            or saved.dtype != like.dtype:
        got = (f"{tuple(saved.shape)} {saved.dtype}"
               if isinstance(saved, torch.Tensor) else type(saved).__name__)
        raise ValueError(f"checkpoint {what} is {got}, the run's "
                         f"{tuple(like.shape)} {like.dtype}: the model or "
                         "optimizer flags differ from the run that saved it")
    return saved.to(like.device)


def restore_state(like: TrainState, saved: dict):
    """``(state, generator states, start_step)`` from a checkpoint dict,
    shaped and placed as the fresh state ``like`` (its params, optimizer
    state and carries). Raises ``ValueError`` when the checkpoint does not
    fit: another model, optimizer or ``--stateful``."""
    leaves = param_leaves(like.params)
    if len(saved["params"]) != len(leaves):
        raise ValueError(f"checkpoint has {len(saved['params'])} param "
                         f"tensors, the run {len(leaves)}")
    params = params_from_leaves(like.params, [
        _match(f"param {i}", t, ref)
        for i, (t, ref) in enumerate(zip(saved["params"], leaves))])
    opt = saved["opt_state"]
    if sorted(opt) != sorted(like.opt_state):
        raise ValueError(f"checkpoint optimizer state {sorted(opt)}, the "
                         f"run's {sorted(like.opt_state)}")
    new_opt = {}
    for k, ref in like.opt_state.items():
        if isinstance(ref, list):
            if not isinstance(opt[k], list) or len(opt[k]) != len(ref):
                raise ValueError(f"checkpoint optimizer state {k!r} does "
                                 "not match the run's")
            new_opt[k] = [_match(f"{k}[{i}]", t, r)
                          for i, (t, r) in enumerate(zip(opt[k], ref))]
        else:
            new_opt[k] = _match(k, opt[k], ref)
    carries = saved["carries"]
    if (carries is None) != (like.carries is None) or (
            carries is not None and len(carries) != len(like.carries)):
        raise ValueError("checkpoint carries do not match the run's "
                         "(--stateful differs)")
    if carries is not None:
        carries = [(_match("h", h, rh), _match("c", c, rc))
                   for (h, c), (rh, rc) in zip(carries, like.carries)]
    state = TrainState(int(saved["step"]), params, new_opt, carries)
    return state, list(saved["generators"]), int(saved["start_step"])


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


class Training(NamedTuple):
    """A run as the train command wires it, before its loop: the first
    ``state``, the train call ``step`` and its ``feed`` (what
    :func:`train_loop` drives), the eval of the final record
    (``eval_fn(params) -> record``), :func:`train_loop`'s other keyword
    arguments (``loop_kw``) and what runs after the final record
    (``generate(params)``: the LM's ``--generate-tokens``, or None)."""

    state: TrainState
    step: Callable
    feed: Iterable
    eval_fn: Callable
    loop_kw: dict
    generate: Callable | None = None


def summarize_scan_metrics(ms: list[dict]) -> dict:
    """The logging contract of a K-step call over its steps' metrics:
    ``loss`` is the mean of the K losses, ``loss_last`` and ``grad_norm``
    the last step's, ``anomalous`` the count of non-finite steps."""
    out = {"loss": torch.stack([m["loss"] for m in ms]).mean(),
           "loss_last": ms[-1]["loss"], "grad_norm": ms[-1]["grad_norm"]}
    if "anomalous" in ms[0]:
        out["anomalous"] = torch.stack([m["anomalous"] for m in ms]).sum()
    return out


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    stateful: bool = False, graph: bool = True, log=None):
    """``train_step(state, batch) -> (state, metrics)`` (see
    :func:`step_body`). On the card the step is captured as a CUDA graph
    at its first call and replayed after (``train/graphs.py``; ``log``
    receives the capture record); ``graph=False`` runs it eagerly, as the
    CPU always does."""
    from .graphs import graphed

    def body(state: TrainState, feed, do_eval):
        return step_body(loss_fn, optimizer, state, feed, stateful=stateful)

    return graphed(body, route="train_step", graph=graph, log=log)


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
               best_metric: str | None = None, best_mode: str = "max",
               steps_per_call: int = 1,
               fused_eval: Callable[[dict], dict] | None = None,
               checkpoint_fn: Callable[[TrainState], Any] | None = None,
               checkpoint_every: int = 0) -> TrainState:
    """Drive ``train_step`` over ``batches``, logging every ``log_every``
    calls (loss, grad_norm, steps_per_sec, tokens_per_sec and
    examples_per_sec when given per batch) and calling ``eval_fn(params)``
    every ``eval_every`` calls. With ``best_metric`` (e.g.
    ``eval_accuracy`` under ``best_mode="max"``, ``eval_mse`` under
    ``"min"``), an eval that improves it (NaN never counts) is logged as a
    ``new best`` record.

    With ``steps_per_call=K`` each iteration is one K-step call
    (``train/multistep.py``, ``train/device_step.py``): ``num_steps``,
    ``log_every`` and ``eval_every`` count calls, and the rates are scaled
    by K to stay in optimizer steps, tokens and examples per second. With
    ``fused_eval`` the step is ``train_step(state, batch, do_eval)`` and
    runs the eval itself on the calls of the eval cadence; the eval record
    is ``fused_eval(metrics)`` in place of ``eval_fn``. ``checkpoint_fn(
    state)`` runs every ``checkpoint_every`` calls, after the call's eval.

    Reading the logged loss is the only host sync of a logged call; with
    ``anomaly_limit=K`` (off at 0) every call's ``anomalous`` count is read
    too, and K consecutive anomalous steps raise
    :class:`AnomalousTrainingError` (a call whose steps were all anomalous
    extends the run, any other resets it)."""
    if best_mode not in ("min", "max"):
        raise ValueError(f"best_mode must be 'min' or 'max', got "
                         f"{best_mode!r}")
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
        if fused_eval is not None:
            do_eval = bool(eval_every) and step % eval_every == 0
            state, metrics = train_step(state, batch, do_eval)
        else:
            state, metrics = train_step(state, batch)
        last_metrics = metrics
        if anomaly_limit:
            bad = int(metrics["anomalous"].item())  # sync point (documented)
            anomalous_total += bad
            if bad >= steps_per_call:
                anomalous_consec += bad
            else:
                anomalous_consec = 0
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
            window = log_every * steps_per_call
            record = {"step": state.step, "loss": loss,
                      "grad_norm": float(metrics["grad_norm"].item()),
                      "steps_per_sec": window / dt}
            if anomaly_limit:
                if anomalous_total:
                    record["anomalous_steps"] = anomalous_total
            else:
                bad = float(metrics["anomalous"].item())
                if bad:
                    record["anomalous"] = bad
            if tokens_per_batch:
                record["tokens_per_sec"] = tokens_per_batch * window / dt
            if examples_per_batch:
                record["examples_per_sec"] = examples_per_batch * window / dt
            if logger is not None:
                logger.log(record)
        if eval_every and step % eval_every == 0 and (
                fused_eval is not None or eval_fn is not None):
            ev = (fused_eval(metrics) if fused_eval is not None
                  else eval_fn(state.params))
            if logger is not None:
                logger.log({"step": state.step, **ev})
            v = ev.get(best_metric) if best_metric else None
            if v is not None and v == v and (
                    best is None
                    or (v < best if best_mode == "min" else v > best)):
                best = v
                if logger is not None:
                    logger.log({"step": state.step,
                                "note": f"new best {best_metric}",
                                best_metric: v})
            # the eval's time is not training throughput
            window_start = time.perf_counter()
        if (checkpoint_fn is not None and checkpoint_every
                and step % checkpoint_every == 0):
            checkpoint_fn(state)
            window_start = time.perf_counter()
    if last_metrics is not None:
        last_metrics["loss"].item()  # the last queued step has finished
    return state
