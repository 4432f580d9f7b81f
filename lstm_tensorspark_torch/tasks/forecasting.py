"""The seq2seq forecasting task (BASELINE.md config 4), one device.

Port of ``lstm_tensorspark_tpu/tasks/forecasting.py::run_forecaster`` on
its single-device branches: the electricity load series (or its synthetic
stand-in) → (context, horizon) windows, reshuffled every epoch →
``train_loop`` on the teacher-forced MSE, with a free-running eval of the
valid split (``eval_mse``, ``eval_mae``, weighted by valid rows; a ``new
best eval_mse`` record when the MSE falls) → a final eval record
(:func:`forecaster_training` builds the run, the train command's loop
drives it). ``--steps-per-call``, ``--prefetch``, ``--device-data`` (the
series staged on the device, each batch a gather of its windows by [K, B]
window starts in ``forecast_starts``' order), ``--fused-eval`` (the
stacked eval batches staged on the device, the free-running eval inside
the train call), ``--remat-chunk`` (the encoder's) and checkpoints as for
the other tasks. ``--compute-dtype`` reaches every recurrence (bfloat16
by default: the resident pair's bfloat16 forms on the card at config 4's
shapes). ``--dropout`` is ignored, as JAX's loss ignores it; the weights
come from a CPU generator seeded with ``--seed``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..exit_codes import UsageError

HORIZON = 24  # one day of hours


def forecaster_training(args, dev: torch.device, logger, *,
                        graph: bool = True):
    """The forecaster's run for the train command's ``args``, built but
    not started: a :class:`train.loop.Training`. Raises
    :class:`UsageError` for what the task refuses."""
    from ..data import (cap_batches, epoch_stream, forecast_starts,
                        forecast_windows, get_dataset, index_groups,
                        slice_forecast_batch, stage_series,
                        stage_stacked_batches)
    from ..models.seq2seq import (Seq2SeqConfig, forecast, init_seq2seq,
                                  seq2seq_loss, seq2seq_params_to)
    from ..train import (host_feed, init_train_state, make_device_train_step,
                         make_multi_train_step, make_optimizer,
                         make_train_step)
    from ..train.checkpoint import wire_checkpoint
    from ..train.loop import Training, device_batches

    if args.stateful:
        raise UsageError("--stateful applies to contiguous-stream LM "
                         "training only (forecast windows are independent)")
    data = get_dataset("uci_electricity", args.data_path)
    if data["synthetic"]:
        logger.log({"note": "dataset uci_electricity: using synthetic "
                            "stand-in"})
    context_len = args.seq_len or 168  # one week of hours
    horizon = HORIZON
    F = data["num_features"]
    cfg = Seq2SeqConfig(num_features=F, hidden_size=args.hidden_units,
                        num_layers=args.num_layers, horizon=horizon,
                        compute_dtype=args.compute_dtype,
                        remat_chunk=args.remat_chunk)
    B = args.batch_size
    k = args.steps_per_call
    train_series, valid_series = data["train"], data["valid"]
    n_windows = max(len(train_series) - context_len - horizon + 1, 0)
    if n_windows < B:
        raise UsageError(f"train series too short: {n_windows} windows < "
                         f"batch {B}")
    steps_per_epoch = max(n_windows // B, 1)

    params = seq2seq_params_to(
        init_seq2seq(torch.Generator().manual_seed(args.seed), cfg), dev)
    graph_kw = {"graph": graph, "log": logger.log}

    def loss_fn(params, batch):
        return seq2seq_loss(params, batch, cfg)

    optimizer = make_optimizer(
        args.optimizer, args.learning_rate, momentum=args.momentum,
        clip_norm=args.clip_norm, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, decay_steps=args.decay_steps)
    state = init_train_state(params, optimizer)
    # no dropout: no generator to save or restore
    state, start, checkpoint_fn = wire_checkpoint(args, logger, state, [])

    has_eval = len(valid_series) >= context_len + horizon
    fused_eval = args.fused_eval
    if fused_eval and not has_eval:
        logger.log({"note": "fused-eval: valid series shorter than one "
                            "window; falling back to host-driven eval"})
        fused_eval = False
    metric_keys = ("eval_mse", "eval_mae")

    def metric_fn(p, b):
        preds = forecast(p, b["context"], cfg)
        w = b["valid"].to(torch.float32)
        n = torch.clamp(w.sum(), min=1.0)
        err = (preds - b["targets"]) * w[:, None, None]
        per_elem = float(horizon * preds.shape[-1])
        return {"eval_mse": (err ** 2).sum() / (n * per_elem),
                "eval_mae": err.abs().sum() / (n * per_elem)}, w.sum()

    def eval_batches():
        """The eval batches of the host eval and of the fused eval's
        staging: one constructor, so the two see the same batches."""
        return cap_batches(
            forecast_windows(valid_series, context_len, horizon, min(B, 64),
                             drop_remainder=False), args.eval_batches)

    def eval_fn(params):
        """The free-running MSE and MAE over the valid split, weighted by
        valid rows (the last batch's filler rows count for nothing); the
        forecasts are read back once, after the last batch is queued."""
        if not has_eval:
            return {"eval_skipped": 1}
        batches = list(eval_batches())
        with torch.no_grad():
            preds = [forecast(params, b["context"], cfg)
                     for b in device_batches(batches, dev)]
        tot_n = tot_mse = tot_mae = 0.0
        for b, p in zip(batches, torch.stack(preds).cpu().numpy()):
            err = (p - b["targets"])[b["valid"]]
            n = b["valid"].sum()
            tot_mse += float((err ** 2).mean()) * n
            tot_mae += float(np.abs(err).mean()) * n
            tot_n += n
        tot_n = max(tot_n, 1.0)
        return {"eval_mse": tot_mse / tot_n, "eval_mae": tot_mae / tot_n}

    fused_kw = {}
    if fused_eval:
        fused_kw = {"metric_fn": metric_fn, "metric_keys": metric_keys,
                    "eval_batches": stage_stacked_batches(eval_batches(),
                                                          device=dev)}
    if args.device_data:
        # the series on the device; each batch gathered by window starts in
        # forecast_windows' shuffled order
        staged = stage_series(train_series, context_len, horizon, device=dev)
        window_fn = functools.partial(slice_forecast_batch,
                                      context_len=context_len,
                                      horizon=horizon)
        train_step = make_device_train_step(loss_fn, optimizer, window_fn,
                                            staged.arrays, **fused_kw,
                                            **graph_kw)
        feed = index_groups(
            lambda epoch: forecast_starts(staged.num_windows,
                                          shuffle_seed=args.seed + epoch),
            B, k, start_step=start)
    else:
        stacked = k > 1 or fused_eval
        train_step = (make_multi_train_step(loss_fn, optimizer, **fused_kw,
                                            **graph_kw) if stacked
                      else make_train_step(loss_fn, optimizer, **graph_kw))
        feed = host_feed(
            epoch_stream(
                lambda epoch: forecast_windows(train_series, context_len,
                                               horizon, B,
                                               shuffle_seed=args.seed + epoch),
                steps_per_epoch=steps_per_epoch, start_step=start),
            dev, steps_per_call=k, stacked=stacked, prefetch=args.prefetch)

    logger.log({"note": "start", "dataset": "uci_electricity",
                "features": F, "context": context_len, "horizon": horizon,
                "device": str(dev),
                "device_name": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                "steps_per_epoch": steps_per_epoch, "backend": "single"})
    # a resumed run trains the rest of the budget
    total = max((args.num_steps if args.num_steps is not None
                 else args.epochs * steps_per_epoch) - state.step, 0)
    return Training(
        state, train_step, feed, eval_fn,
        dict(num_steps=-(-total // k),  # K-step calls, rounded up
             checkpoint_fn=checkpoint_fn,
             checkpoint_every=args.checkpoint_every,
             log_every=args.log_every,
             eval_fn=None if fused_eval else (eval_fn if args.eval_every
                                              else None),
             eval_every=args.eval_every,
             tokens_per_batch=B * context_len,
             anomaly_limit=args.anomaly_limit,
             best_metric="eval_mse", best_mode="min", steps_per_call=k,
             fused_eval=((lambda ms: {k2: float(ms[k2])
                                      for k2 in metric_keys})
                         if fused_eval else None)))
