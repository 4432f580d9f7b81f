"""The bi-LSTM classification task (BASELINE.md config 2), one device.

Port of ``lstm_tensorspark_tpu/tasks/classification.py::run_classifier``
on its single-device, host-fed branch: the IMDB examples (or their
synthetic stand-in) → length-bucketed padded batches, reshuffled every
epoch → ``train_loop`` with the valid-weighted eval (``eval_loss``,
``eval_accuracy``, a ``new best eval_accuracy`` record when it improves)
→ a final eval record. Dropout keep masks come from a generator on the
training device seeded with ``--seed + 1``; the weights from a CPU
generator seeded with ``--seed``.
"""

from __future__ import annotations

import sys

import torch

from ..exit_codes import ANOMALY_RC, OK_RC, USAGE_RC


def run_classifier(args, dev: torch.device, logger) -> int:
    from ..data import cap_batches, epoch_stream, get_dataset, padded_batches
    from ..models.classifier import (ClassifierConfig, classifier_loss,
                                     classifier_params_to, init_classifier)
    from ..train import (AnomalousTrainingError, evaluate_classifier,
                         init_train_state, make_optimizer, make_train_step,
                         train_loop)
    from ..train.loop import device_batches

    if args.stateful:
        print("train: --stateful applies to contiguous-stream LM training "
              "only (classification examples are independent)",
              file=sys.stderr)
        return USAGE_RC
    max_len = args.seq_len or 400  # config 2's length
    data = get_dataset("imdb", args.data_path, max_len=max_len)
    if data["synthetic"]:
        logger.log({"note": "dataset imdb: using synthetic stand-in"})
    vocab = data["vocab"]
    cfg = ClassifierConfig(
        vocab_size=len(vocab), num_classes=data["num_classes"],
        hidden_size=args.hidden_units, num_layers=args.num_layers,
        dropout=args.dropout, remat_chunk=args.remat_chunk)
    B = args.batch_size
    train_seqs, train_labels = data["train"]
    valid_seqs, valid_labels = data["valid"]
    if len(train_seqs) < B:
        print(f"train: train set too small: {len(train_seqs)} examples < "
              f"batch {B}", file=sys.stderr)
        return USAGE_RC

    params = classifier_params_to(
        init_classifier(torch.Generator().manual_seed(args.seed), cfg), dev)
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def loss_fn(params, batch):
        return classifier_loss(params, batch, cfg, dropout_gen=drop_gen)

    optimizer = make_optimizer(
        args.optimizer, args.learning_rate, momentum=args.momentum,
        clip_norm=args.clip_norm, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, decay_steps=args.decay_steps)
    state = init_train_state(params, optimizer)
    steps_per_epoch = max(len(train_seqs) // B, 1)

    @torch.no_grad()
    def eval_step(params, batch):
        return classifier_loss(params, batch, cfg)[1]

    def eval_fn(params):
        if not valid_seqs:
            return {"eval_skipped": 1}
        eval_bs = min(B, len(valid_seqs))
        batches = cap_batches(
            padded_batches(valid_seqs, valid_labels, eval_bs, max_len,
                           drop_remainder=False), args.eval_batches)
        return evaluate_classifier(eval_step, params,
                                   device_batches(batches, dev))

    logger.log({"note": "start", "dataset": "imdb", "vocab": len(vocab),
                "max_len": max_len, "device": str(dev),
                "device_name": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                "steps_per_epoch": steps_per_epoch, "backend": "single"})
    stream = epoch_stream(
        lambda epoch: padded_batches(train_seqs, train_labels, B, max_len,
                                     shuffle_seed=args.seed + epoch),
        steps_per_epoch=steps_per_epoch)
    total = (args.num_steps if args.num_steps is not None
             else args.epochs * steps_per_epoch)
    try:
        state = train_loop(
            state, make_train_step(loss_fn, optimizer),
            device_batches(stream, dev), num_steps=total,
            log_every=args.log_every, logger=logger,
            eval_fn=eval_fn if args.eval_every else None,
            eval_every=args.eval_every, tokens_per_batch=B * max_len,
            examples_per_batch=B, anomaly_limit=args.anomaly_limit,
            best_metric="eval_accuracy")
    except AnomalousTrainingError as e:
        print(f"anomaly abort: {e} (exit {ANOMALY_RC})", file=sys.stderr)
        return ANOMALY_RC
    logger.log({"step": state.step, **eval_fn(state.params), "note": "final"})
    return OK_RC
