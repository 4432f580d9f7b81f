"""K-step train calls over data staged on the device, and the eval fused
into a train call.

Port of the single-device part of
``lstm_tensorspark_tpu/train/device_step.py``. The call takes the staged
arrays (``data/device_dataset.py``) and a small index feed, and each of
its K steps cuts its batch out of the arrays on the device: the LM's
window ``w0 + i`` (mod the epoch's windows; the call's feed is one int32)
or the classifier's rows ``idxs[i]`` (the feed is a [K, B] index array).
The steps are the shared :func:`step_body`, so a device-fed run takes
the same steps as a host-fed one. On the card the call is one CUDA graph
(``train/graphs.py``) whose index buffer the host rewrites before each
replay; the slices read it on the device.

The fused eval is the on-device form of the host eval loops: the
token-weighted LM loss over the staged valid stream (carries threaded from
zeros when stateful) or the weighted metrics over stacked eval batches. It
runs after the K steps on the calls of the eval cadence; the others report
NaN, as JAX's ``lax.cond`` does. (The data-parallel builders wait for the
port's ``parallel/``.)
"""

from __future__ import annotations

from typing import Callable

import torch

from ..data.device_dataset import DeviceLMData, slice_window
from .graphs import graphed
from .loop import TrainState, call_loss, step_body, summarize_scan_metrics
from .optimizer import Optimizer


def scan_indexed(loss_fn, optimizer, state, arrays, idxs, *, window_fn,
                 stateful):
    """:func:`step_body` over the leading [K] axis of ``idxs``, each step's
    batch ``window_fn(arrays, idxs[i])``."""
    ms = []
    for i in range(idxs.shape[0]):
        state, m = step_body(loss_fn, optimizer, state,
                             window_fn(arrays, idxs[i]), stateful=stateful)
        ms.append(m)
    return state, summarize_scan_metrics(ms)


# ---- the eval bodies (the on-device forms of the host eval loops) ----


def _nan(like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("nan"), dtype=torch.float32,
                      device=like.device)


@torch.no_grad()
def device_eval_batches(metric_fn, params, eval_batches, keys) -> dict:
    """Weighted mean over stacked [n, ...] eval batches: ``metric_fn(params,
    batch) -> (metrics, weight)``; ``{k: sum(m_k * w) / sum(w)}``."""
    tot = wt = None
    for i in range(next(iter(eval_batches.values())).shape[0]):
        m, w = metric_fn(params, {k: v[i] for k, v in eval_batches.items()})
        w = w.to(torch.float32)
        part = {k: m[k].to(torch.float32) * w for k in keys}
        tot = part if tot is None else {k: tot[k] + part[k] for k in keys}
        wt = w if wt is None else wt + w
    wt = torch.clamp(wt, min=1.0)
    return {k: tot[k] / wt for k in keys}


def gated_eval_batches(metric_fn, state, eval_batches, do_eval, ms, keys):
    if do_eval:
        ms.update(device_eval_batches(metric_fn, state.params, eval_batches,
                                      keys))
    else:
        ms.update({k: _nan(ms["loss"]) for k in keys})
    return ms


@torch.no_grad()
def device_lm_eval(loss_fn, params, eval_arrays, n_windows, seq_len, *,
                   stateful, eval_carries):
    """The token-weighted loss over the first ``n_windows`` windows of the
    staged valid stream (``evaluate()``'s on-device body): sum(loss·tokens)
    / sum(tokens), the carries threaded when stateful."""
    carries = eval_carries
    tot = None
    weight = 0.0
    for w in range(n_windows):
        loss, aux = call_loss(loss_fn, params,
                              slice_window(eval_arrays, w, seq_len), carries,
                              stateful=stateful)
        tok = (aux["tokens"] if isinstance(aux, dict) and "tokens" in aux
               else 1.0)
        tot = loss * tok if tot is None else tot + loss * tok
        weight += tok
        if stateful:
            carries = aux["carries"]
    # divide by a tensor: the card turns a division by a Python float into
    # a reciprocal multiply
    return tot / torch.full((), max(weight, 1.0), dtype=torch.float32,
                            device=tot.device)


def gated_lm_eval(loss_fn, state, eval_arrays, do_eval, ms, *, n_windows,
                  seq_len, stateful, eval_carries):
    ms["eval_loss"] = (
        device_lm_eval(loss_fn, state.params, eval_arrays, n_windows,
                       seq_len, stateful=stateful, eval_carries=eval_carries)
        if do_eval else _nan(ms["loss"]))
    return ms


def fused_tail(eval_loss_fn, *, eval_data=None, eval_windows=None,
               eval_carries=None, metric_fn=None, metric_keys=(),
               eval_batches=None, stateful=False):
    """The eval tail a fused builder appends after its K steps,
    ``tail(state, metrics, do_eval) -> metrics``, or None without eval
    data: the LM's over the staged valid stream ``eval_data`` (at most
    ``eval_windows`` windows, ``eval_carries`` the carries it starts from
    when stateful), or the classifier's ``metric_fn`` over the stacked
    ``eval_batches``."""
    if eval_data is not None:
        n_ev = min(eval_data.n_windows, eval_windows or eval_data.n_windows)

        def tail(state, ms, do_eval):
            return gated_lm_eval(eval_loss_fn, state, eval_data.arrays,
                                 do_eval, ms, n_windows=n_ev,
                                 seq_len=eval_data.seq_len,
                                 stateful=stateful, eval_carries=eval_carries)

        return tail
    if metric_fn is not None:
        keys = tuple(metric_keys)

        def tail(state, ms, do_eval):
            return gated_eval_batches(metric_fn, state, eval_batches,
                                      do_eval, ms, keys)

        return tail
    return None


# ---- the builders ----


def make_device_train_step(loss_fn: Callable, optimizer: Optimizer,
                           window_fn: Callable, arrays: dict, *,
                           metric_fn: Callable | None = None,
                           metric_keys=(), eval_batches: dict | None = None,
                           stateful: bool = False, graph: bool = True,
                           log=None):
    """The device-fed K-step call ``step(state, idxs, do_eval=False)`` over
    the staged ``arrays``: ``idxs`` is a [K, ...] index array (host or
    device), each step's batch ``window_fn(arrays, idxs[i])`` (e.g.
    ``take_batch``).

    With ``metric_fn`` (``metric_fn(params, batch) -> (metrics, weight)``)
    the call is fused: the weighted eval over the stacked ``eval_batches``
    runs after the K steps when ``do_eval``; its metrics appear under
    ``metric_keys`` (NaN on the other calls). ``graph``, ``log``: as
    :func:`train.graphs.graphed`."""
    tail = fused_tail(None, metric_fn=metric_fn, metric_keys=metric_keys,
                      eval_batches=eval_batches)

    def body(state: TrainState, feed, do_eval):
        state, ms = scan_indexed(loss_fn, optimizer, state, arrays,
                                 feed["idxs"], window_fn=window_fn,
                                 stateful=stateful)
        return state, ms if tail is None else tail(state, ms, do_eval)

    run = graphed(body, route="device_train_step", graph=graph,
                  fused=tail is not None, log=log)

    def step(state: TrainState, idxs, do_eval: bool = False):
        return run(state, {"idxs": torch.as_tensor(idxs)}, do_eval)

    return step


def lm_window_idxs(w0: torch.Tensor, data: DeviceLMData,
                   steps_per_call: int) -> torch.Tensor:
    """The call's K window indices ``(w0 + i) mod n_windows``, on the
    device."""
    return torch.remainder(
        w0.to(torch.int32) + torch.arange(steps_per_call, dtype=torch.int32,
                                          device=w0.device),
        data.n_windows)


def make_device_lm_train_step(loss_fn: Callable, optimizer: Optimizer,
                              data: DeviceLMData, *,
                              eval_data: DeviceLMData | None = None,
                              eval_windows: int | None = None,
                              eval_carries=None, steps_per_call: int = 1,
                              stateful: bool = False,
                              eval_loss_fn: Callable | None = None,
                              graph: bool = True, log=None):
    """The LM's device-fed call ``step(state, w0, do_eval=False)``: K =
    ``steps_per_call`` steps over the staged ``data``'s windows ``w0, w0 +
    1, ...`` (wrapping around the epoch), ``w0`` a host int.

    With ``eval_data`` (a staged valid stream) the call is fused: its
    ``metrics["eval_loss"]`` is the token-weighted valid loss when
    ``do_eval``, NaN otherwise; ``eval_windows`` caps the eval (the
    ``--eval-batches`` bound), ``eval_carries`` are the carries it starts
    from when stateful, and ``eval_loss_fn`` is its deterministic loss
    (default ``loss_fn``). ``graph``, ``log``: as
    :func:`train.graphs.graphed`."""
    tail = fused_tail(eval_loss_fn or loss_fn, eval_data=eval_data,
                      eval_windows=eval_windows, eval_carries=eval_carries,
                      stateful=stateful)

    def window_fn(arrays, w):
        return slice_window(arrays, w, data.seq_len)

    def body(state: TrainState, feed, do_eval):
        idxs = lm_window_idxs(feed["w0"], data, steps_per_call)
        state, ms = scan_indexed(loss_fn, optimizer, state, data.arrays, idxs,
                                 window_fn=window_fn, stateful=stateful)
        return state, ms if tail is None else tail(state, ms, do_eval)

    run = graphed(body, route=f"device_lm_train_step_k{steps_per_call}",
                  graph=graph, fused=tail is not None, log=log)

    def step(state: TrainState, w0, do_eval: bool = False):
        return run(state, {"w0": torch.tensor(int(w0), dtype=torch.int32)},
                   do_eval)

    return step
