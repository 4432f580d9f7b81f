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
  backward (JAX's choice when it is set). ``--compute-dtype`` defaults to
  bfloat16 and ``--logits-dtype`` to float32, as JAX's command: the
  recurrences of every task run the kernels' bfloat16
  forms on the card unless ``--compute-dtype float32`` is given;
  ``--logits-dtype`` is an LM flag, which imdb ignores as JAX's does.
  ``--dataset uci_electricity`` trains the seq2seq forecaster
  (BASELINE.md config 4, ``tasks/forecasting.py``): ``--seq-len`` is its
  context (default 168 hours) before a 24-hour horizon; it ignores
  ``--logits-dtype`` and ``--dropout``, as JAX's does.
  A run of ``--anomaly-limit`` consecutive non-finite steps exits with
  ``ANOMALY_RC``. ``--checkpoint-dir`` with ``--checkpoint-every N`` saves
  the run's whole state every N calls (``train/checkpoint.py``);
  ``--resume`` restarts from the newest valid one, bit for bit where the
  uninterrupted run would be (params, optimizer state, carries, the
  dropout generators and the data cursor), and refuses, as JAX's
  ``_wire_checkpoint`` does, a directory whose checkpoints were all
  quarantined (an empty directory is a fresh start).
- ``serve --selftest`` decodes ``--sessions`` concurrent sessions through
  the full server path and checks that the greedy tokens equal the plain
  ``models/generate.generate`` on the CPU for the same weights (rc 0 on
  PASS, 1 on a mismatch or a request error); with ``--speculative`` the
  sessions decode by speculative windows (a draft of ``draft_config``'s
  shape proposes, the target verifies), and the run also fails when no
  speculative window was dispatched;
- ``serve --http`` warms the engine and serves ``POST /v1/generate``,
  ``GET /healthz`` and ``GET /v1/stats`` until interrupted.

Serving runs as JAX's ``cli serve`` does by default: the prefix cache on
(``--prefix-cache``, ``--prefix-stride``, ``--prefix-entries``) and the
tiered session cache on (``--tiered-cache``, ``--host-tier-entries``);
``--session-dir`` adds the disk tier and the kept sessions' checkpoints (a
server restarted on it continues them), ``--prefill-chunk N`` consumes
prompts N tokens a dispatch and serves prompts longer than the largest
prefill bucket.

Serve weights come from ``--checkpoint-dir`` (the newest valid
checkpoint: the port's ``step_<N>.pt`` or the JAX package's
``step_<N>.msgpack``; a directory whose checkpoints are all corrupt is
refused, never served as random init), else are drawn from ``--seed``.
``--compute-dtype bfloat16`` serves through the windows' bfloat16 forms.
``--device`` defaults to ``cuda`` and fails without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading

import numpy as np
import torch

from .exit_codes import ANOMALY_RC, FAIL_RC, OK_RC, USAGE_RC, UsageError
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
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="dtype of the recurrence's products (bfloat16: the "
                        "decode and spec windows' bfloat16 forms)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="serve the trained params of the newest valid "
                        "checkpoint there (step_<N>.pt of this package or "
                        "step_<N>.msgpack of the JAX package; the model "
                        "flags must match the training run's); seeded "
                        "random weights otherwise")
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=OPTIMIZERS,
                   help="the training run's optimizer (a checkpoint's "
                        "optimizer state must match it)")
    p.add_argument("--learning-rate", type=float, default=1.0,
                   help="accepted as the JAX command takes it (restore "
                        "only)")
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
    p.add_argument("--prefix-cache", type=str, default="on",
                   choices=["on", "off"],
                   help="shared-prompt prefix-state cache: fresh prompts "
                        "resume prefill from the longest cached prefix (an "
                        "LSTM prefix state is one (h, c) pair: reuse is a "
                        "slot copy). Greedy output is token-identical on or "
                        "off; 'off' frees the backing slots")
    p.add_argument("--prefix-stride", type=int, default=8,
                   help="prefix-cache insert granularity (tokens): entries "
                        "live at stride-aligned prompt lengths")
    p.add_argument("--prefix-entries", type=int, default=16,
                   help="max cached prefix entries (each holds one "
                        "state-cache slot; LRU beyond this)")
    p.add_argument("--tiered-cache", type=str, default="on",
                   choices=["on", "off"],
                   help="tiered session-state cache: evicted session states "
                        "spill asynchronously to host RAM, with a durable "
                        "disk tier below (--session-dir); continuations of "
                        "spilled sessions fill back instead of failing "
                        "'expired'. 'off' keeps the fixed-slot behaviour "
                        "(evicted = expired)")
    p.add_argument("--host-tier-entries", type=int, default=256,
                   help="max spilled session states held in host RAM; "
                        "overflow cascades to --session-dir or is dropped")
    p.add_argument("--session-dir", type=str, default=None,
                   help="disk tier and serve-session checkpoints: kept "
                        "sessions are written behind here at each request "
                        "boundary (sha256-verified atomic files), so a "
                        "killed and restarted server continues them "
                        "token-identically; also the overflow tier below "
                        "--host-tier-entries. Implies the tiered cache even "
                        "with --tiered-cache off")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked prefill: consume prompts <= N tokens a "
                        "dispatch, at most one prefill dispatch a scheduler "
                        "iteration, which bounds how long a long prompt "
                        "stalls running sessions and lifts the "
                        "prompt-length cap. 0 = off")
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


def _checkpoint_params(args, params):
    """The params of the newest valid checkpoint in ``--checkpoint-dir``
    (CPU tensors), checked against ``params``'s shapes (the model flags)
    and, for the port's own files, the optimizer state against
    ``--optimizer``'s (a JAX file is read for its params alone). Exits when
    the directory holds none, or when every one is corrupt (quarantined):
    a serve command never falls back to random weights."""
    from .convert import params_from_numpy
    from .train.checkpoint import Checkpointer
    from .train.jax_checkpoint import params_tree
    from .train.loop import init_train_state, param_leaves, restore_state
    from .train.optimizer import make_optimizer

    found = [c for c in (Checkpointer(args.checkpoint_dir, fmt=f)
                         for f in ("torch", "jax")) if c.has_checkpoint()]
    if not found:
        raise SystemExit(f"serve: no checkpoint in {args.checkpoint_dir}")
    ckpt = max(found, key=lambda c: c.latest_step())  # the port's on a tie
    like = init_train_state(params, make_optimizer(args.optimizer,
                                                   args.learning_rate))

    def parse(state):
        if ckpt.fmt == "jax":
            got = params_from_numpy(params_tree(state), device="cpu")
            state = {"step": int(np.asarray(state["step"])),
                     "params": param_leaves(got),
                     "opt_state": like.opt_state, "generators": [],
                     "start_step": 0}
        return restore_state(like, dict(state, carries=None))[0]

    state = ckpt.restore_latest(parse)
    if state is None:
        raise SystemExit(
            f"serve: every checkpoint in {args.checkpoint_dir} is corrupt "
            "(now quarantined); refusing to serve an untrained model")
    print(f"serve: params of step {state.step} "
          f"({ckpt.path_for(state.step)})", flush=True)
    return state.params


def _build_serve_stack(args):
    """(cpu params, cfg, server) from the serve flags."""
    from .models.lstm_lm import LMConfig, init_lm
    from .serve import ServeEngine, ServeServer
    from .train.distill import draft_config

    chunk = args.prefill_chunk or None
    if (chunk is not None and chunk > 0 and args.prefix_cache == "on"
            and chunk % args.prefix_stride != 0
            and args.prefix_stride % chunk != 0):
        # the batcher's own rule, checked before the weights are made
        raise SystemExit(
            f"--prefill-chunk {chunk} must be a multiple or divisor of "
            f"--prefix-stride {args.prefix_stride} (chunk stops are "
            "stride-aligned prefix insert points), or use --prefix-cache off")
    cfg = LMConfig(vocab_size=args.vocab_size, hidden_size=args.hidden_units,
                   num_layers=args.num_layers,
                   tie_embeddings=args.tie_embeddings,
                   compute_dtype=args.compute_dtype)
    gen = torch.Generator().manual_seed(args.seed)
    params = init_lm(gen, cfg)
    if args.checkpoint_dir:
        params = _checkpoint_params(args, params)
    try:
        engine = ServeEngine(
            params, cfg, device=args.device, num_slots=args.num_slots,
            prefill_buckets=_parse_buckets(args.prefill_buckets,
                                           "--prefill-buckets"),
            batch_buckets=_parse_buckets(args.batch_buckets,
                                         "--batch-buckets"),
            rng_seed=args.seed,
            prefix_cache=args.prefix_cache == "on",
            prefix_stride=args.prefix_stride,
            prefix_entries=args.prefix_entries,
            tiered_cache=args.tiered_cache == "on",
            host_tier_entries=args.host_tier_entries,
            session_dir=args.session_dir)
    except ValueError as e:  # e.g. --prefix-stride 0
        raise SystemExit(f"serve: {e}")
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
            window_ladder=_parse_window_ladder(args.decode_window),
            prefill_chunk=chunk, **spec_kw)
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
        "window_form": stats["engine"]["window_form"],
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
        description="train the LSTM language model, with --dataset "
                    "imdb the bi-LSTM classifier, or with --dataset "
                    "uci_electricity the seq2seq forecaster on "
                    "PyTorch/CUDA (one device)")
    p.add_argument("--dataset", type=str, default="ptb_char",
                   choices=["ptb_char", "wikitext2", "wikitext103", "imdb",
                            "uci_electricity"],
                   help="ptb_char, wikitext2, wikitext103 (LM), imdb "
                        "(bi-LSTM classifier) and uci_electricity (seq2seq "
                        "forecaster)")
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
                        "example length, default 400; uci_electricity: "
                        "context length, default 168)")
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
                        "also on the final states; the forecaster ignores "
                        "it); training steps only")
    p.add_argument("--remat-chunk", type=int, default=None,
                   help="checkpoint the recurrence in chunks of N steps: "
                        "the backward recomputes them (T % N == 0)")
    p.add_argument("--tie-embeddings", action="store_true")
    p.add_argument("--compute-dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="dtype of the recurrence's products (every "
                        "task); parameters, optimizer state and cell state "
                        "stay float32")
    p.add_argument("--logits-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="dtype of the materialized [B,T,V] LM logits (the "
                        "NLL still runs in float32 over the upcast "
                        "values); LM tasks only: imdb and uci_electricity "
                        "ignore it")
    p.add_argument("--stateful", action="store_true",
                   help="carry recurrent state across contiguous windows")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="K optimizer steps per host call (one CUDA graph "
                        "replay on the card); log and eval cadences then "
                        "count K-step calls")
    p.add_argument("--prefetch", type=int, default=0,
                   help="prefetch depth of the host feed: a background "
                        "thread pins and copies the next batches on a copy "
                        "stream (0 = off)")
    p.add_argument("--device-data", action="store_true",
                   help="stage the dataset on the device once and cut the "
                        "batches there (LM: window slices; imdb: row "
                        "gather); a call's host feed shrinks to indices")
    p.add_argument("--fused-eval", action="store_true",
                   help="run the periodic eval inside the train call, on "
                        "eval data staged on the device (with "
                        "--device-data or the host feed; needs "
                        "--eval-every)")
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--eval-batches", type=int, default=None,
                   help="cap each eval pass at N batches")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="where the run's checkpoints go (step_<N>.pt)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save a checkpoint every N calls (0 = never)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest valid checkpoint in "
                        "--checkpoint-dir (an empty one: a fresh start)")
    p.add_argument("--anomaly-limit", type=int, default=0,
                   help="exit with ANOMALY_RC after K consecutive non-finite "
                        "steps (one host sync per step while on; 0 = off)")
    p.add_argument("--jsonl", type=str, default=None,
                   help="metrics JSONL path")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def _refusal(args) -> str | None:
    """What the train command refuses in ``args`` before it builds
    anything, or None."""
    if not 0.0 <= args.dropout < 1.0:
        return f"--dropout must be in [0, 1), got {args.dropout}"
    if args.eval_batches is not None and args.eval_batches < 1:
        return f"--eval-batches must be >= 1, got {args.eval_batches}"
    if args.remat_chunk is not None and args.remat_chunk < 1:
        return f"--remat-chunk must be >= 1, got {args.remat_chunk}"
    if args.steps_per_call < 1:
        return f"--steps-per-call must be >= 1, got {args.steps_per_call}"
    if args.fused_eval and not args.eval_every:
        return ("--fused-eval needs --eval-every > 0 (it fuses the "
                "periodic eval pass into the train call)")
    if args.device_data and args.prefetch:
        return "--device-data has no host feed; drop --prefetch"
    if args.checkpoint_every < 0:
        return f"--checkpoint-every must be >= 0, got {args.checkpoint_every}"
    if (args.resume or args.checkpoint_every) and not args.checkpoint_dir:
        return "--resume and --checkpoint-every need --checkpoint-dir"
    return None


def training(argv, *, graph: bool = True, logger=None):
    """The run ``train <argv>`` would make, built but not started (a
    :class:`train.loop.Training`: state, train call, feed, final eval and
    the loop's arguments), on the device the flags name: the command's own
    wiring, for a caller that drives the calls itself (the card's smoke run
    times and profiles them). ``logger`` receives the run's records (a
    quiet one by default). Raises :class:`UsageError` for what the command
    refuses."""
    from .device import configure_precision, resolve_device
    from .train import MetricsLogger

    args = build_train_parser().parse_args(list(argv))
    refused = _refusal(args)
    if refused:
        raise UsageError(refused)
    dev = resolve_device(args.device)
    configure_precision()
    return _training(args, dev, logger or MetricsLogger(quiet=True), graph)


def _training(args, dev, logger, graph):
    if args.dataset == "imdb":
        from .tasks.classification import classifier_training

        return classifier_training(args, dev, logger, graph=graph)
    if args.dataset == "uci_electricity":
        from .tasks.forecasting import forecaster_training

        return forecaster_training(args, dev, logger, graph=graph)
    return _lm_training(args, dev, logger, graph)


def _run_train(args, graph: bool = True) -> int:
    from .device import configure_precision, resolve_device
    from .train import AnomalousTrainingError, MetricsLogger, train_loop

    refused = _refusal(args)
    if refused:
        print(f"train: {refused}", file=sys.stderr)
        return USAGE_RC
    dev = resolve_device(args.device)
    configure_precision()
    with MetricsLogger(args.jsonl) as logger:
        try:
            run = _training(args, dev, logger, graph)
        except UsageError as e:
            print(f"train: {e}", file=sys.stderr)
            return USAGE_RC
        try:
            state = train_loop(run.state, run.step, run.feed, logger=logger,
                               **run.loop_kw)
        except AnomalousTrainingError as e:
            print(f"anomaly abort: {e} (exit {ANOMALY_RC})", file=sys.stderr)
            return ANOMALY_RC
        logger.log({"step": state.step, **run.eval_fn(state.params),
                    "note": "final"})
    return OK_RC


def _lm_training(args, dev, logger, graph):
    """The LM's run (configs 1, 3 and 5), built but not started."""
    from .data import (cap_batches, get_dataset, lm_batch_stream,
                       lm_epoch_batches, stage_lm_data, window_index_stream)
    from .models.lstm_lm import LMConfig, init_carries, init_lm, lm_loss, params_to
    from .train import (evaluate, host_feed, init_train_state,
                        make_device_lm_train_step, make_eval_step,
                        make_multi_train_step, make_optimizer,
                        make_train_step)
    from .train.checkpoint import wire_checkpoint
    from .train.loop import Training, device_batches, eval_metrics

    seq_len = args.seq_len or 64
    B = args.batch_size
    k = args.steps_per_call
    try:
        data = get_dataset(args.dataset, args.data_path)
    except ValueError as e:
        raise UsageError(str(e)) from e
    if data["synthetic"]:
        logger.log({"note": f"dataset {args.dataset}: no files at "
                            "--data-path, using synthetic stand-in"})
    vocab = data["vocab"]
    cfg = LMConfig(vocab_size=len(vocab), hidden_size=args.hidden_units,
                   num_layers=args.num_layers,
                   tie_embeddings=args.tie_embeddings,
                   remat_chunk=args.remat_chunk, dropout=args.dropout,
                   compute_dtype=args.compute_dtype,
                   logits_dtype=args.logits_dtype)
    drop_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def train_loss_fn(params, batch, carries=None):
        return lm_loss(params, batch, cfg, carries=carries,
                       dropout_gen=drop_gen)

    def loss_fn(params, batch, carries=None):  # eval: deterministic
        return lm_loss(params, batch, cfg, carries=carries)

    params = params_to(init_lm(torch.Generator().manual_seed(args.seed), cfg),
                       dev)
    optimizer = make_optimizer(
        args.optimizer, args.learning_rate, momentum=args.momentum,
        clip_norm=args.clip_norm, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, decay_steps=args.decay_steps)
    stateful = args.stateful
    state = init_train_state(
        params, optimizer,
        carries=init_carries(cfg, B, device=dev) if stateful else None)
    state, start, checkpoint_fn = wire_checkpoint(args, logger, state,
                                                  [drop_gen])
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

    fused_eval = args.fused_eval
    if fused_eval and eval_bs <= 0:
        logger.log({"note": "fused-eval: valid split smaller than one "
                            "window; falling back to host-driven eval"})
        fused_eval = False
    kw = {"stateful": stateful, "graph": graph, "log": logger.log}
    fused_kw = {}
    if fused_eval:
        fused_kw = {
            "eval_data": stage_lm_data(valid_tokens, eval_bs, seq_len,
                                       device=dev),
            "eval_windows": args.eval_batches, "eval_loss_fn": loss_fn,
            "eval_carries": (init_carries(cfg, eval_bs, device=dev)
                             if stateful else None)}
    if args.device_data:
        ddata = stage_lm_data(train_tokens, B, seq_len, device=dev)
        train_step = make_device_lm_train_step(
            train_loss_fn, optimizer, ddata, steps_per_call=k, **fused_kw,
            **kw)
        feed = window_index_stream(ddata, k, start_step=start)
    else:
        stacked = k > 1 or fused_eval
        train_step = (make_multi_train_step(train_loss_fn, optimizer,
                                            **fused_kw, **kw) if stacked
                      else make_train_step(train_loss_fn, optimizer, **kw))
        feed = host_feed(lm_batch_stream(train_tokens, B, seq_len,
                                         start_step=start), dev,
                         steps_per_call=k, stacked=stacked,
                         prefetch=args.prefetch)

    logger.log({"note": "start", "dataset": args.dataset,
                "vocab": len(vocab), "device": str(dev),
                "device_name": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                "steps_per_epoch": steps_per_epoch, "backend": "single"})
    # a resumed run trains the rest of the budget
    total = max((args.num_steps if args.num_steps is not None
                 else args.epochs * steps_per_epoch) - state.step, 0)
    return Training(
        state, train_step, feed, eval_fn,
        # each loop iteration is one K-step call: round up so the step
        # budget is never undershot
        dict(num_steps=-(-total // k), log_every=args.log_every,
             checkpoint_fn=checkpoint_fn,
             checkpoint_every=args.checkpoint_every,
             eval_fn=(None if fused_eval
                      else eval_fn if args.eval_every else None),
             eval_every=args.eval_every, tokens_per_batch=B * seq_len,
             anomaly_limit=args.anomaly_limit, steps_per_call=k,
             fused_eval=((lambda ms: eval_metrics(float(ms["eval_loss"])))
                         if fused_eval else None)))


def main(argv=None, *, graph: bool = True) -> int:
    """The command line. ``graph=False`` runs every train call eagerly on
    the card too, instead of replaying its CUDA graph: the form the card's
    smoke run compares the captured runs with (not a flag)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "train":
        return _run_train(build_train_parser().parse_args(argv[1:]), graph)
    if not argv or argv[0] != "serve":
        print("usage: python -m lstm_tensorspark_torch {train,serve} [flags]; "
              "see train --help, serve --help", file=sys.stderr)
        return USAGE_RC
    args = build_serve_parser().parse_args(argv[1:])
    if args.selftest:
        return _serve_selftest(args)
    return _serve_http(args)
