"""The bi-LSTM classification task (BASELINE.md config 2), one device.

Port of ``lstm_tensorspark_tpu/tasks/classification.py::run_classifier``
on its single-device branch: the IMDB examples (or their synthetic
stand-in) → length-bucketed padded batches, reshuffled every epoch →
``train_loop`` with the valid-weighted eval (``eval_loss``,
``eval_accuracy``, a ``new best eval_accuracy`` record when it improves)
→ a final eval record (:func:`classifier_training` builds the run, the
train command's loop drives it). ``--steps-per-call``, ``--prefetch``,
``--device-data`` (the padded examples staged on the device, each batch
a row gather by [K, B] indices in ``example_order``) and ``--fused-eval``
(the stacked eval batches staged on the device, the eval inside the train
call) as for the LM. ``--compute-dtype`` reaches every train and eval
step through the model's config (bfloat16 by default, as JAX's command:
the residentx kernels' bfloat16 forms on the card). Dropout keep masks come from a generator on the
training device seeded with ``--seed + 1``; the weights from a CPU
generator seeded with ``--seed``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..exit_codes import UsageError


def classifier_training(args, dev: torch.device, logger, *,
                        graph: bool = True):
    """The classifier's run for the train command's ``args``, built but
    not started: a :class:`train.loop.Training`. Raises
    :class:`UsageError` for what the task refuses."""
    from ..data import (cap_batches, epoch_stream, example_order, get_dataset,
                        index_groups, padded_batches, stage_examples,
                        stage_stacked_batches, take_batch)
    from ..models.classifier import (ClassifierConfig, classifier_loss,
                                     classifier_params_to, init_classifier)
    from ..train import (evaluate_classifier, host_feed, init_train_state,
                         make_device_train_step, make_multi_train_step,
                         make_optimizer, make_train_step)
    from ..train.checkpoint import wire_checkpoint
    from ..train.loop import Training, device_batches

    if args.stateful:
        raise UsageError("--stateful applies to contiguous-stream LM "
                         "training only (classification examples are "
                         "independent)")
    max_len = args.seq_len or 400  # config 2's length
    data = get_dataset("imdb", args.data_path, max_len=max_len)
    if data["synthetic"]:
        logger.log({"note": "dataset imdb: using synthetic stand-in"})
    vocab = data["vocab"]
    cfg = ClassifierConfig(
        vocab_size=len(vocab), num_classes=data["num_classes"],
        hidden_size=args.hidden_units, num_layers=args.num_layers,
        dropout=args.dropout, compute_dtype=args.compute_dtype,
        remat_chunk=args.remat_chunk)
    B = args.batch_size
    k = args.steps_per_call
    train_seqs, train_labels = data["train"]
    valid_seqs, valid_labels = data["valid"]
    if len(train_seqs) < B:
        raise UsageError(f"train set too small: {len(train_seqs)} examples "
                         f"< batch {B}")

    params = classifier_params_to(
        init_classifier(torch.Generator().manual_seed(args.seed), cfg), dev)
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    graph_kw = {"graph": graph, "log": logger.log}

    def loss_fn(params, batch):
        return classifier_loss(params, batch, cfg, dropout_gen=drop_gen)

    optimizer = make_optimizer(
        args.optimizer, args.learning_rate, momentum=args.momentum,
        clip_norm=args.clip_norm, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, decay_steps=args.decay_steps)
    state = init_train_state(params, optimizer)
    state, start, checkpoint_fn = wire_checkpoint(args, logger, state,
                                                  [drop_gen])
    steps_per_epoch = max(len(train_seqs) // B, 1)

    fused_eval = args.fused_eval
    if fused_eval and not valid_seqs:
        logger.log({"note": "fused-eval: empty valid split; falling back "
                            "to host-driven eval"})
        fused_eval = False
    metric_keys = ("eval_loss", "eval_accuracy")

    def metric_fn(p, b):
        _, aux = classifier_loss(p, b, cfg)
        w = b["valid"].to(torch.float32).sum()
        return {"eval_loss": aux["loss"], "eval_accuracy": aux["accuracy"]}, w

    def eval_batches():
        """The eval batches of the host eval and of the fused eval's
        staging: one constructor, so the two see the same batches."""
        eval_bs = min(B, len(valid_seqs))
        return cap_batches(
            padded_batches(valid_seqs, valid_labels, eval_bs, max_len,
                           drop_remainder=False), args.eval_batches)

    @torch.no_grad()
    def eval_step(params, batch):
        return classifier_loss(params, batch, cfg)[1]

    def eval_fn(params):
        if not valid_seqs:
            return {"eval_skipped": 1}
        return evaluate_classifier(eval_step, params,
                                   device_batches(eval_batches(), dev))

    fused_kw = {}
    if fused_eval:
        fused_kw = {"metric_fn": metric_fn, "metric_keys": metric_keys,
                    "eval_batches": stage_stacked_batches(eval_batches(),
                                                          device=dev)}
    if args.device_data:
        # the padded example matrix on the device; each batch gathered by
        # row indices in padded_batches' shuffle-and-bucket order
        N = len(train_seqs)
        toks = np.zeros((N, max_len), np.int32)
        lens = np.zeros((N,), np.int32)
        for r, seq in enumerate(train_seqs):
            seq = seq[:max_len]
            toks[r, :len(seq)] = seq
            lens[r] = len(seq)
        staged = stage_examples(
            {"tokens": toks, "lengths": lens,
             "labels": np.asarray(train_labels, np.int32),
             "valid": np.ones((N,), bool)}, device=dev)
        train_step = make_device_train_step(loss_fn, optimizer, take_batch,
                                            staged.arrays, **fused_kw,
                                            **graph_kw)
        lengths_all = [len(s) for s in train_seqs]
        feed = index_groups(
            lambda epoch: example_order(lengths_all,
                                        shuffle_seed=args.seed + epoch),
            B, k, start_step=start)
    else:
        stacked = k > 1 or fused_eval
        train_step = (make_multi_train_step(loss_fn, optimizer, **fused_kw,
                                            **graph_kw) if stacked
                      else make_train_step(loss_fn, optimizer, **graph_kw))
        feed = host_feed(
            epoch_stream(
                lambda epoch: padded_batches(train_seqs, train_labels, B,
                                             max_len,
                                             shuffle_seed=args.seed + epoch),
                steps_per_epoch=steps_per_epoch, start_step=start),
            dev, steps_per_call=k, stacked=stacked, prefetch=args.prefetch)

    logger.log({"note": "start", "dataset": "imdb", "vocab": len(vocab),
                "max_len": max_len, "device": str(dev),
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
             eval_every=args.eval_every, tokens_per_batch=B * max_len,
             examples_per_batch=B, anomaly_limit=args.anomaly_limit,
             best_metric="eval_accuracy", steps_per_call=k,
             fused_eval=((lambda ms: {k2: float(ms[k2])
                                      for k2 in metric_keys})
                         if fused_eval else None)))
