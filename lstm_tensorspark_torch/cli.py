"""Command line of the port: ``python -m lstm_tensorspark_torch {train,serve}``.

- ``train`` trains the LSTM LM on the char corpus (BASELINE.md config 1 by
  its flags) or a word corpus (``--dataset wikitext2|wikitext103``, configs
  3 and 5), as the JAX package's ``cli._run_lm`` does on one device with
  a host-fed stream: dataset → config → init → optimizer → batch stream →
  ``train_loop`` (log, eval cadence) → a final eval record; ``--dropout``
  between layers, its keep masks drawn from a seeded generator on the
  run's device (training steps only). ``--dataset imdb`` trains the
  bi-LSTM classifier instead (BASELINE.md config 2,
  ``tasks/classification.py``). ``--remat-chunk`` takes the recompute
  backward (JAX's choice when it is set). Float32 only;
  ``--compute-dtype bfloat16``, ``--logits-dtype bfloat16`` and
  ``--dataset uci_electricity`` exit with ``USAGE_RC`` (not ported yet). A
  run of ``--anomaly-limit`` consecutive non-finite steps exits with
  ``ANOMALY_RC``.
- ``serve --selftest`` decodes ``--sessions`` concurrent sessions through
  the full server path and checks that the greedy tokens equal the plain
  ``models/generate.generate`` on the CPU for the same weights (rc 0 on
  PASS, 1 on a mismatch or a request error); with ``--speculative`` the
  sessions decode by speculative windows (a draft of ``draft_config``'s
  shape proposes, the target verifies), and the run also fails when no
  speculative window was dispatched;
- ``serve --http`` warms the engine and serves ``POST /v1/generate``,
  ``GET /healthz`` and ``GET /v1/stats`` until interrupted.

Weights are drawn from ``--seed`` (serving a trained checkpoint waits for
the port's checkpoints). ``--device`` defaults to ``cuda`` and
fails without a card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading

import numpy as np
import torch

from .exit_codes import ANOMALY_RC, FAIL_RC, OK_RC, USAGE_RC
from .train.optimizer import OPTIMIZERS

DEFAULT_WINDOW_LADDER = (1, 4, 8)
DEFAULT_SPEC_LADDER = "2,4"


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lstm_tensorspark_torch serve",
        description="continuous-batching LM inference on PyTorch/CUDA: "
                    "HTTP endpoint or --selftest parity check")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--selftest", action="store_true",
                      help="decode concurrent sessions and check greedy "
                           "output against the plain generate on the CPU")
    mode.add_argument("--http", action="store_true",
                      help="serve POST /v1/generate until interrupted")
    p.add_argument("--vocab-size", type=int, default=89)
    p.add_argument("--hidden-units", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--tie-embeddings", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-slots", type=int, default=64,
                   help="device state-cache slots (concurrent sessions)")
    p.add_argument("--prefill-buckets", type=str, default="8,16,32,64,128",
                   help="comma-separated prompt-length buckets")
    p.add_argument("--batch-buckets", type=str, default="1,2,4,8,16",
                   help="comma-separated batch-size buckets")
    p.add_argument("--max-active", type=int, default=16,
                   help="sessions decoding at once (<= --num-slots)")
    p.add_argument("--queue-size", type=int, default=64,
                   help="bounded submit queue (full -> HTTP 429)")
    p.add_argument("--decode-window", type=str, default="auto",
                   help="'auto' = window ladder 1/4/8; an int N caps the "
                        "ladder at N (1 pins one token per step)")
    p.add_argument("--speculative", action="store_true",
                   help="lossless speculative decoding of greedy requests: "
                        "a draft LM (train/distill.draft_config of the "
                        "target: 1 layer, H/4) proposes K_draft tokens and "
                        "the target verifies them in one pass; output is "
                        "the plain greedy sequence. The draft's weights are "
                        "drawn from --seed + 1 (the JAX CLI's registry "
                        "draft, --draft-model, is not ported)")
    p.add_argument("--spec-ladder", type=str, default=DEFAULT_SPEC_LADDER,
                   help="warmed K_draft rungs (comma list, each >= 1; rung "
                        "0 = plain decode is always added)")
    p.add_argument("--spec-k", type=int, default=None,
                   help="initial K_draft (a --spec-ladder rung or 0; "
                        "default: the top rung)")
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--sessions", type=int, default=8,
                   help="--selftest: concurrent sessions")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def _parse_buckets(spec: str, flag: str) -> tuple[int, ...]:
    try:
        buckets = tuple(int(x) for x in spec.split(",") if x.strip())
    except ValueError:
        raise SystemExit(f"{flag}: expected comma-separated ints, got {spec!r}")
    if not buckets or any(b < 1 for b in buckets):
        raise SystemExit(f"{flag}: need at least one positive bucket")
    return buckets


def _parse_window_ladder(spec: str) -> tuple[int, ...]:
    if spec.strip().lower() == "auto":
        return DEFAULT_WINDOW_LADDER
    try:
        n = int(spec)
    except ValueError:
        raise SystemExit(f"--decode-window: expected 'auto' or a positive "
                         f"int, got {spec!r}")
    if n < 1:
        raise SystemExit(f"--decode-window: window must be >= 1, got {n}")
    return tuple(sorted({1, n} | {k for k in DEFAULT_WINDOW_LADDER if k < n}))


def _parse_spec_ladder(spec: str) -> tuple[int, ...]:
    """--spec-ladder → the warmed K_draft rungs (the Batcher adds 0)."""
    try:
        rungs = tuple(int(x) for x in spec.split(",") if x.strip())
    except ValueError:
        raise SystemExit(f"--spec-ladder: expected comma-separated ints, "
                         f"got {spec!r}")
    if not rungs or any(k < 1 for k in rungs):
        raise SystemExit(f"--spec-ladder: need at least one rung >= 1, got "
                         f"{spec!r}")
    return rungs


def _build_serve_stack(args):
    """(cpu params, cfg, server) from the serve flags."""
    from .models.lstm_lm import LMConfig, init_lm
    from .serve import ServeEngine, ServeServer
    from .train.distill import draft_config

    cfg = LMConfig(vocab_size=args.vocab_size, hidden_size=args.hidden_units,
                   num_layers=args.num_layers,
                   tie_embeddings=args.tie_embeddings)
    gen = torch.Generator().manual_seed(args.seed)
    params = init_lm(gen, cfg)
    engine = ServeEngine(
        params, cfg, device=args.device, num_slots=args.num_slots,
        prefill_buckets=_parse_buckets(args.prefill_buckets,
                                       "--prefill-buckets"),
        batch_buckets=_parse_buckets(args.batch_buckets, "--batch-buckets"),
        rng_seed=args.seed)
    spec_kw = {}
    if args.speculative:
        dcfg = draft_config(cfg)
        engine.attach_draft(
            init_lm(torch.Generator().manual_seed(args.seed + 1), dcfg), dcfg)
        spec_kw = {"speculative": True,
                   "spec_ladder": _parse_spec_ladder(args.spec_ladder),
                   "spec_k": args.spec_k}
    try:
        server = ServeServer(
            engine, max_active=args.max_active, queue_size=args.queue_size,
            window_ladder=_parse_window_ladder(args.decode_window), **spec_kw)
    except ValueError as e:  # e.g. --spec-k off the ladder
        raise SystemExit(f"serve: {e}")
    return params, cfg, server


def _serve_selftest(args) -> int:
    from .models.generate import generate
    from .serve import InprocessClient

    params, cfg, server = _build_serve_stack(args)
    rng = np.random.RandomState(args.seed)
    lengths = [3, 5, 8, 13, 2, 7][:max(args.sessions, 2)]
    while len(lengths) < args.sessions:
        lengths.append(int(rng.randint(2, min(21, server.engine.max_prompt_len))))
    prompts = [rng.randint(0, cfg.vocab_size, size=t).astype(np.int32)
               for t in lengths]
    n_new = args.max_new_tokens
    server.warmup(prompt_lens=tuple(lengths))
    got: list[list[int] | None] = [None] * len(prompts)
    errors: list[str] = []
    client = InprocessClient(server)

    def run_one(i):
        try:
            got[i] = client.generate(prompts[i], max_new_tokens=n_new)
        except Exception as e:  # noqa: BLE001 — report, don't hang the join
            errors.append(f"session {i}: {type(e).__name__}: {e}")

    with server:
        threads = [threading.Thread(target=run_one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        print("\n".join(errors))
        print("serve selftest: FAIL (request errors)")
        return FAIL_RC
    bad = 0
    for i, prompt in enumerate(prompts):
        ref = generate(params, prompt[None, :], cfg, max_new_tokens=n_new,
                       greedy=True, device="cpu")[0, prompt.size:]
        if got[i] != ref.tolist():
            bad += 1
            print(f"session {i}: MISMATCH serve={got[i]} ref={ref.tolist()}")
    stats = server.stats()
    print(json.dumps({
        "note": "serve_selftest", "device": str(server.device),
        "sessions": len(prompts), "tokens_per_session": n_new,
        "mismatches": bad,
        "decode_kernel": stats["engine"]["decode_kernel"],
        "kernel_launches": stats["engine"]["kernel_launches"],
        "spec_kernel_launches": stats["engine"]["spec_kernel_launches"],
        **stats["batcher"],
    }))
    if (args.speculative and n_new >= 3
            and not sum(stats["batcher"]["spec_windows_dispatched"].values())):
        # 3 new tokens leave 2 after prefill, the least a spec window takes
        print("session decode dispatched no speculative window")
        bad += 1
    print(f"serve selftest: {'PASS' if bad == 0 else 'FAIL'}")
    return OK_RC if bad == 0 else FAIL_RC


def _serve_http(args) -> int:
    from .serve import make_http_server

    _, _, server = _build_serve_stack(args)
    print("serve: warming up...", flush=True)
    n = server.warmup(prompt_lens=server.engine.prefill_buckets)
    print(f"serve: {n} warm-up dispatches on {server.device}", flush=True)
    httpd = make_http_server(server, args.host, args.port)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port} (POST /v1/generate, "
          "GET /healthz, GET /v1/stats) — ctrl-C to stop", flush=True)
    with server:
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
    return OK_RC


def build_train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lstm_tensorspark_torch train",
        description="train the LSTM language model or, with --dataset "
                    "imdb, the bi-LSTM classifier on PyTorch/CUDA (one "
                    "device, float32)")
    p.add_argument("--dataset", type=str, default="ptb_char",
                   choices=["ptb_char", "wikitext2", "wikitext103", "imdb",
                            "uci_electricity"],
                   help="ptb_char, wikitext2, wikitext103 (LM) and imdb "
                        "(bi-LSTM classifier); uci_electricity is not "
                        "ported")
    p.add_argument("--data-path", type=str, default=None,
                   help="corpus directory (falls back to the synthetic "
                        "stand-in)")
    p.add_argument("--hidden-units", type=int, default=128)
    p.add_argument("--num-layers", type=int, default=1)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--num-steps", type=int, default=None,
                   help="step budget (overrides --epochs; 0 = eval only)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seq-len", type=int, default=None,
                   help="window length (default 64; imdb: padded "
                        "example length, default 400)")
    p.add_argument("--learning-rate", type=float, default=1.0)
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=OPTIMIZERS)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--clip-norm", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="adamw only")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear LR warmup steps")
    p.add_argument("--decay-steps", type=int, default=None,
                   help="cosine decay horizon in steps (enables the "
                        "warmup-cosine schedule)")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="dropout between layers (the classifier, imdb: "
                        "also on the final states); training steps only")
    p.add_argument("--remat-chunk", type=int, default=None,
                   help="checkpoint the recurrence in chunks of N steps: "
                        "the backward recomputes them (T % N == 0)")
    p.add_argument("--tie-embeddings", action="store_true")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="float32 only so far; bfloat16 is refused")
    p.add_argument("--logits-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="the LM head's dtype: float32 only so far; "
                        "bfloat16 is refused")
    p.add_argument("--stateful", action="store_true",
                   help="carry recurrent state across contiguous windows")
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--eval-batches", type=int, default=None,
                   help="cap each eval pass at N batches")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--anomaly-limit", type=int, default=0,
                   help="exit with ANOMALY_RC after K consecutive non-finite "
                        "steps (one host sync per step while on; 0 = off)")
    p.add_argument("--jsonl", type=str, default=None,
                   help="metrics JSONL path")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def _run_train(args) -> int:
    from .data import cap_batches, get_dataset, lm_batch_stream, lm_epoch_batches
    from .device import configure_precision, resolve_device
    from .models.lstm_lm import LMConfig, init_carries, init_lm, lm_loss, params_to
    from .train import (AnomalousTrainingError, MetricsLogger, evaluate,
                        init_train_state, make_eval_step, make_optimizer,
                        make_train_step, train_loop)
    from .train.loop import device_batches

    refused = None
    if args.compute_dtype != "float32":
        refused = (f"--compute-dtype {args.compute_dtype} is not ported yet "
                   "(float32 only)")
    elif args.logits_dtype != "float32":
        refused = (f"--logits-dtype {args.logits_dtype} is not ported yet "
                   "(float32 only)")
    elif not 0.0 <= args.dropout < 1.0:
        refused = f"--dropout must be in [0, 1), got {args.dropout}"
    elif args.eval_batches is not None and args.eval_batches < 1:
        refused = f"--eval-batches must be >= 1, got {args.eval_batches}"
    elif args.remat_chunk is not None and args.remat_chunk < 1:
        refused = f"--remat-chunk must be >= 1, got {args.remat_chunk}"
    if refused:
        print(f"train: {refused}", file=sys.stderr)
        return USAGE_RC
    dev = resolve_device(args.device)
    configure_precision()
    if args.dataset == "imdb":
        from .tasks.classification import run_classifier

        with MetricsLogger(args.jsonl) as logger:
            return run_classifier(args, dev, logger)
    seq_len = args.seq_len or 64
    B = args.batch_size
    try:
        data = get_dataset(args.dataset, args.data_path)
    except ValueError as e:
        print(f"train: {e}", file=sys.stderr)
        return USAGE_RC
    with MetricsLogger(args.jsonl) as logger:
        if data["synthetic"]:
            logger.log({"note": f"dataset {args.dataset}: no files at "
                                "--data-path, using synthetic stand-in"})
        vocab = data["vocab"]
        cfg = LMConfig(vocab_size=len(vocab), hidden_size=args.hidden_units,
                       num_layers=args.num_layers,
                       tie_embeddings=args.tie_embeddings,
                       remat_chunk=args.remat_chunk, dropout=args.dropout)
        drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

        def train_loss_fn(params, batch, carries=None):
            return lm_loss(params, batch, cfg, carries=carries,
                           dropout_gen=drop_gen)

        def loss_fn(params, batch, carries=None):  # eval: deterministic
            return lm_loss(params, batch, cfg, carries=carries)

        params = params_to(init_lm(torch.Generator().manual_seed(args.seed),
                                   cfg), dev)
        optimizer = make_optimizer(
            args.optimizer, args.learning_rate, momentum=args.momentum,
            clip_norm=args.clip_norm, weight_decay=args.weight_decay,
            warmup_steps=args.warmup_steps, decay_steps=args.decay_steps)
        stateful = args.stateful
        state = init_train_state(
            params, optimizer,
            carries=init_carries(cfg, B, device=dev) if stateful else None)
        train_tokens, valid_tokens = data["train"], data["valid"]
        steps_per_epoch = max((len(train_tokens) - 1) // (B * seq_len), 1)
        # the valid split can be smaller than one training-size window:
        # evaluate with the largest batch that fits
        eval_bs = min(B, max((len(valid_tokens) - 1) // seq_len, 0))
        eval_step = make_eval_step(loss_fn, stateful=stateful)

        def eval_fn(params):
            if eval_bs <= 0:
                return {"eval_skipped": 1}
            ev = cap_batches(lm_epoch_batches(valid_tokens, eval_bs, seq_len),
                             args.eval_batches)
            carries = (init_carries(cfg, eval_bs, device=dev) if stateful
                       else None)
            return evaluate(eval_step, params, device_batches(ev, dev),
                            carries=carries)

        logger.log({"note": "start", "dataset": args.dataset,
                    "vocab": len(vocab), "device": str(dev),
                    "device_name": (torch.cuda.get_device_name(dev)
                                    if dev.type == "cuda" else "cpu"),
                    "steps_per_epoch": steps_per_epoch, "backend": "single"})
        total = (args.num_steps if args.num_steps is not None
                 else args.epochs * steps_per_epoch)
        batches = device_batches(lm_batch_stream(train_tokens, B, seq_len), dev)
        try:
            state = train_loop(
                state, make_train_step(train_loss_fn, optimizer,
                                       stateful=stateful),
                batches, num_steps=total, log_every=args.log_every,
                logger=logger,
                eval_fn=eval_fn if args.eval_every else None,
                eval_every=args.eval_every, tokens_per_batch=B * seq_len,
                anomaly_limit=args.anomaly_limit)
        except AnomalousTrainingError as e:
            print(f"anomaly abort: {e} (exit {ANOMALY_RC})", file=sys.stderr)
            return ANOMALY_RC
        logger.log({"step": state.step, **eval_fn(state.params),
                    "note": "final"})
    return OK_RC


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "train":
        return _run_train(build_train_parser().parse_args(argv[1:]))
    if not argv or argv[0] != "serve":
        print("usage: python -m lstm_tensorspark_torch {train,serve} [flags]; "
              "see train --help, serve --help", file=sys.stderr)
        return USAGE_RC
    args = build_serve_parser().parse_args(argv[1:])
    if args.selftest:
        return _serve_selftest(args)
    return _serve_http(args)
