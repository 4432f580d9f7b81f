"""K optimizer steps per host call, fed by the host.

Port of the single-device part of
``lstm_tensorspark_tpu/train/multistep.py``. JAX stages K batches with a
leading [K] axis and ``lax.scan``s the shared step body over them in one
jitted call. Here the call's body runs the same :func:`step_body` K times
over the stacked batches (``data.batching.stacked_batches``), and on the
card that body is captured as one CUDA graph and replayed once a call
(``train/graphs.py``): the host pays one replay per K steps. On the CPU
the body runs eagerly, which is how the tests hold the K-step call against
K single steps.

Metrics follow :func:`summarize_scan_metrics`: ``loss`` is the mean of the
K steps, ``loss_last`` and ``grad_norm`` the last step's, ``anomalous`` the
count of non-finite steps.

With ``eval_data`` (the LM's staged valid stream) or ``metric_fn``
(stacked classifier eval batches) the builder returns the fused train+eval
call: its eval runs after the K steps, on the calls of the eval cadence
(``do_eval``), from data on the device while the train feed comes from
the host. Its bodies are ``train/device_step.py``'s.

:func:`host_feed` is the feed of every host-fed call, one step or K: the
host batches, stacked when the call takes K, prefetched or copied in the
loop.
"""

from __future__ import annotations

from typing import Callable, Iterable

from ..data.batching import stacked_batches
from ..data.device_dataset import DeviceLMData
from ..data.prefetch import prefetch_to_device
from .device_step import fused_tail
from .graphs import graphed
from .loop import (TrainState, device_batches, step_body,
                   summarize_scan_metrics)
from .optimizer import Optimizer


def scan_steps(loss_fn, optimizer, state, batches, *, stateful):
    """:func:`step_body` over the leading [K] axis of ``batches``."""
    k = next(iter(batches.values())).shape[0]
    ms = []
    for i in range(k):
        state, m = step_body(loss_fn, optimizer, state,
                             {n: v[i] for n, v in batches.items()},
                             stateful=stateful)
        ms.append(m)
    return state, summarize_scan_metrics(ms)


def make_multi_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                          eval_data: DeviceLMData | None = None,
                          eval_windows: int | None = None,
                          eval_carries=None,
                          metric_fn: Callable | None = None,
                          metric_keys=(), eval_batches: dict | None = None,
                          stateful: bool = False,
                          eval_loss_fn: Callable | None = None,
                          graph: bool = True, log=None):
    """The host-fed K-step call ``multi_step(state, batches,
    do_eval=False)``, ``batches`` the usual batch dict with a leading [K]
    axis (K is read from the shapes; one graph per K).

    With ``eval_data`` (the LM's staged valid stream) the call is fused:
    its ``metrics["eval_loss"]`` is the token-weighted valid loss when
    ``do_eval`` (``eval_windows`` caps its windows, ``eval_carries`` are
    the carries it starts from when stateful), NaN otherwise. With
    ``metric_fn`` (``metric_fn(params, batch) -> (metrics, weight)``) the
    fused eval runs over the stacked ``eval_batches`` and the metrics carry
    ``metric_keys``. ``eval_loss_fn`` is the deterministic loss of the LM
    eval (default ``loss_fn``). ``graph``, ``log``: as
    :func:`train.graphs.graphed`."""
    tail = fused_tail(eval_loss_fn or loss_fn, eval_data=eval_data,
                      eval_windows=eval_windows, eval_carries=eval_carries,
                      metric_fn=metric_fn, metric_keys=metric_keys,
                      eval_batches=eval_batches, stateful=stateful)

    def body(state: TrainState, feed, do_eval):
        state, ms = scan_steps(loss_fn, optimizer, state, feed,
                               stateful=stateful)
        return state, ms if tail is None else tail(state, ms, do_eval)

    return graphed(body, route="multi_train_step", graph=graph,
                   fused=tail is not None, log=log)


def host_feed(stream: Iterable[dict], device, *, steps_per_call: int = 1,
              stacked: bool = False, prefetch: int = 0):
    """The feed of a host-fed call, as JAX's ``_setup_training`` wires it
    for the LM and the classifier: ``stream``'s numpy batches, stacked
    ``steps_per_call`` at a time when ``stacked`` (a K-step call; the
    fused call is one even at K = 1), prefetched ``prefetch`` ahead by a
    background thread (``data/prefetch.py``) or else copied to ``device``
    in the loop."""
    if stacked:
        stream = stacked_batches(stream, steps_per_call)
    if prefetch > 0:
        return prefetch_to_device(stream, prefetch, device=device)
    return device_batches(stream, device)
