"""Command line of the port: ``python -m lstm_tensorspark_torch {train,serve,distill}``.

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
  ``--generate-tokens N`` samples N tokens after an LM run (``--prompt``,
  ``--temperature``, ``--top-k``, ``--top-p``, ``--greedy``) and logs
  them as a ``note: "generate"`` record; ``--trace PATH`` writes the run's
  host spans as a Chrome trace.
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
  sessions decode by speculative windows (the draft proposes, the target
  verifies), and the run also fails when no speculative window was
  dispatched. ``--speculative`` needs ``--registry-dir``: the draft is
  the verified pair ``distill`` published there for ``--model-id``
  (``--draft-model`` names another artifact), as JAX's command loads it;
  the reports name its version (``draft``);
- ``serve --http`` warms the engine and serves ``POST /v1/generate``,
  ``GET /healthz``, ``GET /v1/stats`` and ``GET /metrics`` until
  interrupted;
- ``serve --loadgen`` drives the load generator (``serve/loadgen.py``)
  against an in-process server and prints its JSON report (``--json
  PATH`` also writes it, as strict JSON: a value that is not finite is
  null): a closed-loop concurrency sweep (``--compare``, default 1,8) or
  one run (``--compare ''``, ``--mode open`` with an arrival shape, or a
  prefix / inject probe), ``--idle-churn`` (the Zipf kept-session
  workload), ``--workload template-mix`` or, with ``--decode-kernel
  pallas,scan``, the decode-window comparison (``kernel_sweep``).
- ``distill`` trains a draft LM (``train/distill.draft_config``: H/4, one
  layer) against a teacher's logits with JAX's KL + CE loss, the teacher
  from ``--checkpoint-dir`` or from the registry's ``--model-id``, and
  publishes it to ``--registry-dir`` as ``<--model-id>-draft`` (JAX's
  flags, defaults and one-line ``{"distill": ...}`` record, plus the
  kernels the run launched).

Requests of ``--loadgen`` and the ``--http`` warm-up sample as JAX's
command does by default: ``--temperature 1.0``, with ``--top-k`` /
``--top-p`` truncation when given, or argmax with ``--greedy``;
``--selftest`` is greedy. ``--decode-kernel`` picks the decode-window
program (``auto``, ``pallas``: the window kernel, ``scan``: the engine's
scan window); top-k / top-p windows run the scan window, counted in
``decode_window_scan_fallbacks``. ``--trace PATH`` writes a Chrome trace
with one timeline row per request. ``--autotune on`` runs the online
autotuner (``serve/autotune.py``; ``--autotune-interval``, ``--slo-ms``,
``--autotune-chunks``, ``--autotune-host-tier-max``,
``--autotune-be-floor``), off by default as in JAX.

Admission runs as JAX's ``cli serve`` does by default: the router sheds
``best_effort`` at ``--best-effort-queue-frac`` (0.5) of ``--queue-size``
with a ``Retry-After`` from the queue-wait p99, the batcher dequeues the
classes 4:1 (``--class-weights``), no class has a default deadline
(``--deadline-priority-s``, ``--deadline-best-effort-s``), and no tenant is
rate-limited (``--tenant-rate``). ``--telemetry off`` swaps the registry
for no-op instruments. ``--replicas`` other than 1 is refused (the port
serves one replica).

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
    mode.add_argument("--loadgen", action="store_true",
                      help="offline load generation: p50/p99 latency, "
                           "tokens/sec, concurrency sweep (--compare)")
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
                   help="bounded submit queue; beyond it requests are "
                        "rejected (HTTP 429). This is the PRIORITY-class "
                        "bound; best-effort sheds earlier "
                        "(--best-effort-queue-frac)")
    p.add_argument("--replicas", type=str, default="1",
                   help="serving replicas; the port serves one, and "
                        "refuses any other count")
    p.add_argument("--class-weights", type=str, default="4,1",
                   help="weighted-dequeue shares 'priority,best_effort': "
                        "out of every P+B admissions with both classes "
                        "waiting, P are priority")
    p.add_argument("--best-effort-queue-frac", type=float, default=0.5,
                   help="best-effort requests are 429-shed once the live "
                        "queue reaches this fraction of --queue-size "
                        "(priority keeps the remaining headroom); sheds "
                        "carry Retry-After from the live queue-wait p99")
    p.add_argument("--deadline-priority-s", type=float, default=0,
                   help="default request deadline (seconds) for the "
                        "priority class; expiry is enforced in the queue, "
                        "between prefill chunks and at decode-window "
                        "boundaries, producing a 'timeout' outcome with "
                        "partial output. 0 = no default (clients can "
                        "still send deadline_s / X-Deadline-S)")
    p.add_argument("--deadline-best-effort-s", type=float, default=0,
                   help="default request deadline (seconds) for the "
                        "best_effort class; 0 = no default")
    p.add_argument("--tenant-rate", type=float, default=0,
                   help="per-tenant token-bucket rate limit (requests/s "
                        "per distinct 'tenant' request field) on top of "
                        "the class policy; over-rate requests 429 with a "
                        "Retry-After (time to the next token, floored by "
                        "the queue-drain policy). 0 = off; untenanted "
                        "requests are never limited")
    p.add_argument("--tenant-burst", type=float, default=5.0,
                   help="token-bucket burst allowance per tenant")
    p.add_argument("--telemetry", type=str, default="on",
                   choices=["on", "off"],
                   help="metrics registry: 'on' serves GET /metrics "
                        "(Prometheus text: server-side TTFT/ITL/queue-wait "
                        "histograms, outcome, shed and cache counters) and "
                        "histogram summaries in /stats; 'off' swaps in "
                        "no-op instruments")
    p.add_argument("--decode-window", type=str, default="auto",
                   help="'auto' = window ladder 1/4/8; an int N caps the "
                        "ladder at N (1 pins one token per step)")
    p.add_argument("--decode-kernel", type=str, default="auto",
                   help="decode-window program: 'pallas' (the fused window "
                        "kernel, csrc/decode_window.cu; its plain version on "
                        "the CPU), 'scan' (the engine's scan window, plain "
                        "PyTorch), or 'auto' (pallas when the window plan "
                        "takes the model). Top-k / top-p windows fall back "
                        "to scan, counted in decode_window_scan_fallbacks. "
                        "With --loadgen a comma list (e.g. 'pallas,scan') "
                        "runs the comparison: the same workload per "
                        "kernel, tokens/s and ITL deltas, greedy parity")
    p.add_argument("--registry-dir", type=str, default=None,
                   help="model registry directory (serve/registry.py), "
                        "shared with the JAX package: --speculative loads "
                        "its draft from here. The rollout controller JAX's "
                        "server attaches with it is not ported (/rollout "
                        "answers 404)")
    p.add_argument("--model-id", type=str, default="default",
                   help="model id this server boots as (the registry "
                        "namespace of the checkpoint loaded at startup: "
                        "the draft pairs with '<--model-id>')")
    p.add_argument("--speculative", action="store_true",
                   help="lossless speculative decoding of greedy requests: "
                        "a distilled draft LM (published by `distill`, "
                        "loaded from --registry-dir as a verified pair with "
                        "the target) proposes K_draft tokens and the target "
                        "verifies them in one pass; output is the plain "
                        "greedy sequence. Requires --registry-dir")
    p.add_argument("--draft-model", type=str, default=None,
                   help="registry id of the draft artifact (default: "
                        "'<--model-id>-draft', the id `distill` publishes "
                        "under). Its config_hash / parent record must "
                        "verify against the serving target or boot refuses "
                        "the pair")
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
    p.add_argument("--autotune", type=str, default="off",
                   choices=["on", "off"],
                   help="online serve autotuner (serve/autotune.py): a "
                        "controller thread reads windowed deltas of the "
                        "TTFT / ITL / queue-wait histograms and the tiers' "
                        "counters and moves the decode-window cap, the "
                        "prefill chunk, the host-tier bound, the "
                        "best-effort fraction and spec_k, each within what "
                        "warmup warmed. Moves land in /v1/stats 'autotune' "
                        "and serve_autotune_moves_total{knob,direction}. "
                        "Needs --telemetry on")
    p.add_argument("--autotune-interval", type=float, default=0.25,
                   help="seconds between autotuner control windows")
    p.add_argument("--slo-ms", type=float, default=250.0,
                   help="the TTFT p99 SLO (ms) the autotuner protects")
    p.add_argument("--autotune-chunks", type=str, default=None,
                   help="warmed prefill-chunk choices the autotuner moves "
                        "--prefill-chunk among (comma list, each valid as "
                        "--prefill-chunk). Default: half, base and double "
                        "of --prefill-chunk, invalid ones dropped. Ignored "
                        "without --prefill-chunk")
    p.add_argument("--autotune-host-tier-max", type=int, default=0,
                   help="ceiling the autotuner may grow --host-tier-entries "
                        "to under spill thrash (0 = 4x the configured "
                        "entries)")
    p.add_argument("--autotune-be-floor", type=float, default=0.1,
                   help="lowest best-effort fraction the autotuner may "
                        "tighten --best-effort-queue-frac to")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--sessions", type=int, default=8,
                   help="--selftest: concurrent sessions; --loadgen: "
                        "client sessions (--idle-churn: live kept "
                        "sessions; template-mix: one request each)")
    # --- loadgen workload (the JAX command's flags and defaults) ---
    p.add_argument("--requests-per-session", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--mode", type=str, default="closed",
                   choices=["closed", "open"])
    p.add_argument("--rate", type=float, default=None,
                   help="open-loop arrival rate (req/s)")
    p.add_argument("--arrival", type=str, default="fixed",
                   choices=["fixed", "burst", "sine"],
                   help="open-loop arrival shape: 'fixed' = constant "
                        "--rate; 'burst' = --burst-n simultaneous arrivals "
                        "every --burst-gap seconds; 'sine' = rate "
                        "--rate*(1+amp*sin(2pi*t/period))")
    p.add_argument("--arrival-trace", type=str, default=None,
                   help="open-loop trace replay: a file of sorted "
                        "seconds-from-start arrival offsets, one per line "
                        "('#' comments ignored); a trace shorter than the "
                        "workload loops. Overrides --arrival/--rate")
    p.add_argument("--burst-n", type=int, default=8,
                   help="--arrival burst: requests per burst")
    p.add_argument("--burst-gap", type=float, default=0.5,
                   help="--arrival burst: seconds between burst starts")
    p.add_argument("--sine-period", type=float, default=2.0,
                   help="--arrival sine: modulation period (seconds)")
    p.add_argument("--sine-amp", type=float, default=0.8,
                   help="--arrival sine: modulation amplitude in [0, 1)")
    p.add_argument("--compare", type=str, default=None,
                   help="closed-loop concurrency sweep levels (default "
                        "1,8; empty string: single run at --sessions)")
    p.add_argument("--shared-prefix-len", type=int, default=0,
                   help="every prompt shares its first N tokens (the "
                        "shared-system-prompt workload); 0 = random")
    p.add_argument("--inject-prompt-len", type=int, default=0,
                   help="submit ONE extra cold request with a prompt this "
                        "long mid-run (head-of-line-blocking probe, "
                        "reported separately); 0 = off")
    p.add_argument("--inject-delay", type=float, default=0.25,
                   help="seconds into the run to submit the injected "
                        "request")
    p.add_argument("--workload", type=str, default="random",
                   choices=["random", "template-mix"],
                   help="prompt shape: 'random' = per-session random "
                        "prompts; 'template-mix' = tenant preamble x "
                        "few-shot template x unique suffix, on a bounded "
                        "worker pool (--tenants/--templates/"
                        "--preamble-len/--template-len/--suffix-len/"
                        "--workers)")
    p.add_argument("--tenants", type=int, default=4,
                   help="--workload template-mix: distinct tenant "
                        "preambles")
    p.add_argument("--templates", type=int, default=25,
                   help="--workload template-mix: templates per tenant")
    p.add_argument("--preamble-len", type=int, default=128,
                   help="--workload template-mix: tenant preamble tokens")
    p.add_argument("--template-len", type=int, default=32,
                   help="--workload template-mix: template tokens")
    p.add_argument("--suffix-len", type=int, default=8,
                   help="--workload template-mix: unique suffix tokens")
    p.add_argument("--workers", type=int, default=32,
                   help="--workload template-mix: worker-pool size")
    p.add_argument("--idle-churn", action="store_true",
                   help="long-tail workload: --sessions live kept "
                        "sessions continued by Zipf-popularity draws "
                        "(--zipf-s), so the idle tail is evicted and fills "
                        "from the tiers; reports per-tier hit rates, "
                        "re-prefill cost and hot-set tokens/s")
    p.add_argument("--zipf-s", type=float, default=1.1,
                   help="--idle-churn popularity exponent: rank r has "
                        "weight (r+1)^-s")
    p.add_argument("--priority-frac", type=float, default=1.0,
                   help="fraction of traffic submitted as the priority "
                        "class (the rest best_effort, interleaved); "
                        "per-class counts and percentiles land in the "
                        "report's 'classes' section")
    p.add_argument("--deadline-s", type=float, default=0,
                   help="per-request deadline in seconds (server-side; "
                        "expiry = timeout with partial output). 0 = none")
    p.add_argument("--retry-max", type=int, default=0,
                   help="retry a 429 shed up to N times, sleeping the "
                        "server's Retry-After floored by the capped "
                        "exponential backoff + jitter. 0 = no retry")
    p.add_argument("--json", type=str, default=None,
                   help="also write the loadgen report (strict JSON) to "
                        "this path")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--trace", type=str, default=None,
                   help="host-side span trace (Chrome trace JSON), with one "
                        "admit→queue→prefill→decode→readback timeline row "
                        "per request (open in Perfetto)")
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


def _parse_decode_kernels(spec: str) -> tuple[str, ...]:
    from .serve.engine import DECODE_KERNELS

    kernels = tuple(dict.fromkeys(
        k.strip() for k in spec.split(",") if k.strip()))
    bad = [k for k in kernels if k not in DECODE_KERNELS]
    if not kernels or bad:
        raise SystemExit(
            f"--decode-kernel: expected one of {DECODE_KERNELS} (or a "
            f"comma list for the --loadgen comparison), got {spec!r}")
    return kernels


def _single_decode_kernel(args) -> str:
    kernels = _parse_decode_kernels(args.decode_kernel)
    if len(kernels) > 1:
        raise SystemExit(
            f"--decode-kernel {args.decode_kernel!r}: a comma list is the "
            "--loadgen comparison mode; this mode needs a single kernel")
    return kernels[0]


def _autotune_chunk_choices(args, chunk: int | None) -> tuple[int, ...] | None:
    """The warmed chunk sizes the autotuner moves among, as JAX's command
    derives them: explicit ``--autotune-chunks`` entries must each be a
    valid ``--prefill-chunk``; the default is half, base and double of
    the chunk with invalid ones dropped. None without chunking."""
    if chunk is None:
        if args.autotune_chunks:
            raise SystemExit(
                "--autotune-chunks needs --prefill-chunk (the knob moves "
                "among chunk sizes, it cannot turn chunking on)")
        return None
    max_bucket = max(_parse_buckets(args.prefill_buckets,
                                    "--prefill-buckets"))

    def ok(c: int) -> bool:
        if c < 1 or c > max_bucket:
            return False
        return (args.prefix_cache != "on" or c % args.prefix_stride == 0
                or args.prefix_stride % c == 0)

    if args.autotune_chunks:
        try:
            choices = tuple(int(x) for x in args.autotune_chunks.split(",")
                            if x.strip())
        except ValueError:
            raise SystemExit(
                f"--autotune-chunks: expected comma-separated ints, got "
                f"{args.autotune_chunks!r}")
        bad = [c for c in choices if not ok(c)]
        if not choices or bad:
            raise SystemExit(
                f"--autotune-chunks: entries must be in [1, {max_bucket}] "
                f"and stride-compatible with --prefix-stride "
                f"{args.prefix_stride}; bad: {bad or 'empty'}")
        return tuple(sorted(set(choices) | {chunk}))
    derived = {c for c in (chunk // 2, chunk, chunk * 2) if ok(c)}
    return tuple(sorted(derived | {chunk}))


def _autotune_config(args, chunk: int | None):
    """``(AutoTuneConfig or None, chunk choices or None)`` from the
    ``--autotune`` flags, refused as JAX's command refuses them."""
    if args.autotune != "on":
        return None, None
    if args.telemetry == "off":
        raise SystemExit(
            "--autotune on needs --telemetry on (the controller watches "
            "the live serve histograms)")
    from .serve import AutoTuneConfig

    if args.autotune_interval <= 0:
        raise SystemExit(f"--autotune-interval must be > 0, got "
                         f"{args.autotune_interval}")
    if args.slo_ms <= 0:
        raise SystemExit(f"--slo-ms must be > 0, got {args.slo_ms}")
    choices = _autotune_chunk_choices(args, chunk)
    return AutoTuneConfig(
        interval_s=args.autotune_interval, slo_s=args.slo_ms / 1e3,
        host_tier_max=args.autotune_host_tier_max or None,
        best_effort_floor=args.autotune_be_floor), choices


def _parse_class_weights(spec: str) -> tuple[int, int]:
    try:
        wp, wb = (int(x) for x in spec.split(","))
    except ValueError:
        raise SystemExit(
            f"--class-weights: expected 'P,B' positive ints, got {spec!r}")
    if wp < 1 or wb < 1:
        raise SystemExit(
            f"--class-weights: weights must be >= 1, got {spec!r}")
    return wp, wb


def _parse_replicas(spec: str) -> int:
    """--replicas: the JAX command's parse (an int or a comma list of
    positive ints), then the port's refusal of anything but one."""
    try:
        levels = tuple(int(x) for x in spec.split(",") if x.strip())
    except ValueError:
        raise SystemExit(f"--replicas: expected an int or comma-separated "
                         f"ints, got {spec!r}")
    if not levels or any(n < 1 for n in levels):
        raise SystemExit(f"--replicas: need positive replica counts, got "
                         f"{spec!r}")
    if levels != (1,):
        raise SystemExit(
            f"--replicas {spec}: the port serves one replica (multi-replica "
            "serving and the replica sweep are not ported); use --replicas 1")
    return 1


def _checkpoint_params(args, params, cmd: str = "serve"):
    """The params of the newest valid checkpoint in ``--checkpoint-dir``
    (CPU tensors), checked against ``params``'s shapes (the model flags)
    and, for the port's own files, the optimizer state against
    ``--optimizer``'s (a JAX file is read for its params alone). Exits when
    the directory holds none, or when every one is corrupt (quarantined):
    the ``serve`` and ``distill`` commands (``cmd``) never fall back to
    random weights."""
    from .convert import params_from_numpy
    from .train.checkpoint import Checkpointer
    from .train.jax_checkpoint import params_tree
    from .train.loop import init_train_state, param_leaves, restore_state
    from .train.optimizer import make_optimizer

    found = [c for c in (Checkpointer(args.checkpoint_dir, fmt=f)
                         for f in ("torch", "jax")) if c.has_checkpoint()]
    if not found:
        raise SystemExit(f"{cmd}: no checkpoint in {args.checkpoint_dir}")
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
        refusal = {"serve": "serve an untrained model",
                   "distill": "distill an untrained teacher"}[cmd]
        raise SystemExit(
            f"{cmd}: every checkpoint in {args.checkpoint_dir} is corrupt "
            f"(now quarantined); refusing to {refusal}")
    print(f"{cmd}: params of step {state.step} "
          f"({ckpt.path_for(state.step)})", flush=True)
    return state.params


def _serve_draft(args, cfg):
    """``(meta, cpu params, cfg)`` of the draft ``--speculative`` serves:
    the verified pair from ``--registry-dir`` (``train/distill.load_draft``),
    with JAX's refusals."""
    from .serve.registry import RegistryError
    from .train.distill import load_draft

    if not args.registry_dir:
        raise SystemExit(
            "--speculative needs --registry-dir (the draft loads "
            "from the registry as a verified pair with the target; "
            "publish one with `cli distill`)")
    try:
        return load_draft(args.registry_dir, cfg, teacher_id=args.model_id,
                          draft_id=args.draft_model or None)
    except (RegistryError, ValueError, KeyError, OSError) as e:
        raise SystemExit(f"--speculative: cannot load draft: {e}")


def _build_serve_stack(args, registry=None):
    """(cpu params, cfg, server) from the serve flags; ``registry`` (a
    fresh one per stack for the kernel comparison) overrides the
    process-wide default."""
    from . import obs
    from .models.lstm_lm import LMConfig, init_lm
    from .serve import ServeEngine, ServeServer

    chunk = args.prefill_chunk or None
    if (chunk is not None and chunk > 0 and args.prefix_cache == "on"
            and chunk % args.prefix_stride != 0
            and args.prefix_stride % chunk != 0):
        # the batcher's own rule, checked before the weights are made
        raise SystemExit(
            f"--prefill-chunk {chunk} must be a multiple or divisor of "
            f"--prefix-stride {args.prefix_stride} (chunk stops are "
            "stride-aligned prefix insert points), or use --prefix-cache off")
    weights = _parse_class_weights(args.class_weights)
    _parse_replicas(args.replicas)
    decode_kernel = _single_decode_kernel(args)
    autotune, chunk_choices = _autotune_config(args, chunk)
    cfg = LMConfig(vocab_size=args.vocab_size, hidden_size=args.hidden_units,
                   num_layers=args.num_layers,
                   tie_embeddings=args.tie_embeddings,
                   compute_dtype=args.compute_dtype)
    # the pair is verified before any weights are read or placed
    draft = _serve_draft(args, cfg) if args.speculative else None
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
            session_dir=args.session_dir, decode_kernel=decode_kernel,
            registry=(obs.NULL_REGISTRY if args.telemetry == "off"
                      else registry))
    except ValueError as e:  # e.g. --prefix-stride 0
        raise SystemExit(f"serve: {e}")
    spec_kw = {}
    if draft is not None:
        dmeta, dparams, dcfg = draft
        engine.attach_draft(dparams, dcfg, version=dmeta["version"])
        spec_kw = {"speculative": True,
                   "spec_ladder": _parse_spec_ladder(args.spec_ladder),
                   "spec_k": args.spec_k}
    try:
        server = ServeServer(
            engine, max_active=args.max_active, queue_size=args.queue_size,
            window_ladder=_parse_window_ladder(args.decode_window),
            prefill_chunk=chunk, prefill_chunk_choices=chunk_choices,
            autotune=autotune, class_weights=weights,
            best_effort_queue_frac=args.best_effort_queue_frac,
            deadline_defaults={
                "priority": args.deadline_priority_s or None,
                "best_effort": args.deadline_best_effort_s or None},
            tenant_rate=args.tenant_rate or None,
            tenant_burst=args.tenant_burst, **spec_kw)
    except ValueError as e:  # e.g. --spec-k off the ladder
        raise SystemExit(f"serve: {e}")
    return params, cfg, server


def _serve_sampling(args):
    from .serve import SamplingParams

    return SamplingParams(temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, greedy=args.greedy)


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
        "draft": stats["engine"]["draft"],
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
    n = server.warmup(_serve_sampling(args),
                      prompt_lens=server.engine.prefill_buckets)
    print(f"serve: {n} warm-up dispatches on {server.device}", flush=True)
    httpd = make_http_server(server, args.host, args.port)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port} (POST /v1/generate, "
          "GET /healthz, GET /v1/stats, GET /metrics) — ctrl-C to stop",
          flush=True)
    with server:
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
    return OK_RC


def _strict(obj):
    """``obj`` with every float that is not finite replaced by None: the
    loadgen report as strict JSON (a class or a run without samples has
    no percentile)."""
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _strict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_strict(v) for v in obj]
    return obj


def _emit_report(args, out: dict, summary: str) -> int:
    """Print the report (one strict-JSON line) and its one-line summary
    (stderr), and write ``--json`` when given."""
    out = _strict(out)
    print(json.dumps(out, allow_nan=False))
    print(summary, file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True, allow_nan=False)
        print(f"loadgen: report written to {args.json}", file=sys.stderr)
    return OK_RC


def _read_arrival_trace(path: str | None) -> list[float] | None:
    """``--arrival-trace``: sorted seconds-from-start offsets, one float a
    line, blank lines and '#' comments ignored (the load generator checks
    order and sign)."""
    if not path:
        return None
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as e:
        raise SystemExit(f"--arrival-trace: cannot read {path!r}: {e}")
    out: list[float] = []
    for ln in lines:
        ln = ln.split("#", 1)[0].strip()
        if not ln:
            continue
        try:
            out.append(float(ln))
        except ValueError:
            raise SystemExit(
                f"--arrival-trace: bad offset {ln!r} in {path!r}")
    if not out:
        raise SystemExit(f"--arrival-trace: {path!r} has no offsets")
    return out


def _loadgen_engine(server) -> dict:
    """The report's engine section: dispatches, kernel launches, the
    draft (JAX's stats block), prefix totals and the state cache's
    counters."""
    from .serve.loadgen import prefix_totals

    es = server.engine.stats()
    return {"device": es["device"], "decode_kernel": es["decode_kernel"],
            "decode_window_scan_fallbacks":
                es["decode_window_scan_fallbacks"],
            "window_form": es["window_form"], "draft": es["draft"],
            "dispatches": es["dispatches"],
            "kernel_launches": es["kernel_launches"],
            "launch_counts": es["launch_counts"],
            "prefix_cache": prefix_totals(server), **es["cache"]}


def _serve_loadgen(args) -> int:
    from .serve import concurrency_sweep, run_loadgen

    if args.shared_prefix_len and args.shared_prefix_len >= args.prompt_len:
        print(f"error: --shared-prefix-len {args.shared_prefix_len} must be "
              f"< --prompt-len {args.prompt_len} (each prompt needs >= 1 "
              "unshared token)", file=sys.stderr)
        return USAGE_RC
    if (args.arrival != "fixed" or args.arrival_trace) and args.mode != "open":
        print("error: --arrival burst/sine and --arrival-trace shape "
              "OPEN-loop arrivals; add --mode open", file=sys.stderr)
        return USAGE_RC
    kernels = _parse_decode_kernels(args.decode_kernel)
    _parse_replicas(args.replicas)
    if len(kernels) > 1:
        if args.idle_churn:
            print("error: --decode-kernel comparison runs at one replica "
                  "count without --idle-churn", file=sys.stderr)
            return USAGE_RC
        return _serve_loadgen_kernel_sweep(args, kernels)
    if args.idle_churn:
        return _serve_loadgen_longtail(args)
    if args.workload == "template-mix":
        return _serve_loadgen_template_mix(args)
    _, cfg, server = _build_serve_stack(args)
    sampling = _serve_sampling(args)
    # the prefix and inject probes are single-run workloads
    probe_run = bool(args.shared_prefix_len or args.inject_prompt_len)
    if probe_run and args.compare:
        print("note: --shared-prefix-len/--inject-prompt-len run single-run "
              f"at --sessions {args.sessions}; ignoring --compare "
              f"{args.compare!r}", file=sys.stderr)
    compare = "1,8" if args.compare is None else args.compare
    with server:
        if compare and args.mode == "closed" and not probe_run:
            try:
                levels = {int(x) for x in compare.split(",") if x.strip()}
            except ValueError:
                raise SystemExit(f"--compare: expected comma-separated "
                                 f"ints, got {compare!r}")
            out = concurrency_sweep(
                server, vocab_size=cfg.vocab_size,
                levels=tuple(sorted(levels | {args.sessions})),
                requests_per_session=args.requests_per_session,
                prompt_len=args.prompt_len,
                max_new_tokens=args.max_new_tokens,
                sampling=sampling, seed=args.seed)
        else:
            lens = {args.prompt_len}
            # an unchunked inject past the largest bucket has nothing to
            # warm: admission refuses it and the report says so
            if args.inject_prompt_len and (
                    server.batcher.prefill_chunk is not None
                    or args.inject_prompt_len
                    <= server.engine.max_prompt_len):
                lens.add(args.inject_prompt_len)
            server.warmup(sampling, prompt_lens=tuple(lens))
            out = run_loadgen(
                server, vocab_size=cfg.vocab_size, sessions=args.sessions,
                requests_per_session=args.requests_per_session,
                prompt_len=args.prompt_len,
                max_new_tokens=args.max_new_tokens,
                sampling=sampling, mode=args.mode, rate=args.rate,
                seed=args.seed, shared_prefix_len=args.shared_prefix_len,
                inject_prompt_len=args.inject_prompt_len,
                inject_delay_s=args.inject_delay,
                priority_frac=args.priority_frac,
                deadline_s=args.deadline_s or None,
                retry_max=args.retry_max, arrival=args.arrival,
                arrival_times=_read_arrival_trace(args.arrival_trace),
                burst_n=args.burst_n, burst_gap_s=args.burst_gap,
                sine_period_s=args.sine_period, sine_amp=args.sine_amp)
    out["engine"] = _loadgen_engine(server)
    bstats = server.batcher.stats()
    out["batcher"] = {
        k: bstats[k]
        for k in ("window_ladder", "windows_dispatched", "windows_pipelined",
                  "prefill_chunk", "prefill_chunks_dispatched",
                  "prefix_resumed", "prefix_tokens_saved", "timed_out",
                  "class_weights")}
    out["router_totals"] = server.router.stats()
    out["server_metrics"] = server.metrics_summary()
    # the controller's moves (--autotune on); None when off
    out["autotune"] = (None if server.autotuner is None
                       else server.autotuner.stats())
    r = out.get("levels", {}).get(args.sessions, out)
    px = r.get("prefix_cache") or {}
    return _emit_report(args, out, (
        f"loadgen summary: {r.get('completed', '?')} req, "
        f"{r.get('tokens_per_sec', '?')} tok/s, "
        f"ttft p50 {r.get('p50_ttft_ms', '?')} ms, "
        f"itl p99 {r.get('p99_itl_ms', '?')} ms, "
        f"prefix hit rate {px.get('hit_rate', 'n/a')}, "
        f"kernel launches {out['engine']['kernel_launches']}, "
        f"swap generation {out['engine']['generation']}"))


def _serve_loadgen_longtail(args) -> int:
    """``serve --loadgen --idle-churn``: the long-tail kept-session
    workload, with per-tier hit rates, re-prefill cost and hot-set
    tokens/s."""
    from .serve import run_longtail

    _, cfg, server = _build_serve_stack(args)
    sampling = _serve_sampling(args)
    with server:
        # re-prefills replay whole histories, which land on any bucket:
        # warm every final-prefill length
        server.warmup(sampling, prompt_lens=tuple(
            set(server.engine.prefill_buckets) | {args.prompt_len}))
        out = run_longtail(
            server, vocab_size=cfg.vocab_size, sessions=args.sessions,
            requests_per_session=args.requests_per_session,
            prompt_len=args.prompt_len, max_new_tokens=args.max_new_tokens,
            sampling=sampling, zipf_s=args.zipf_s, seed=args.seed)
        out["tier_stats_total"] = {
            r.index: r.engine.stats()["tiers"] for r in server.replicas}
    out["engine"] = _loadgen_engine(server)
    out["server_metrics"] = server.metrics_summary()
    t = out.get("tiers") or {}
    hr = t.get("hit_rates", {})
    hot = out.get("hot_set", {})
    return _emit_report(args, out, (
        f"longtail summary: {out['completed']} req over {args.sessions} "
        f"sessions, {out['tokens_per_sec']} tok/s "
        f"(hot set {hot.get('tokens_per_sec', '?')} tok/s), tier hits "
        f"device {hr.get('device', '?')} / host {hr.get('host', '?')} / "
        f"disk {hr.get('disk', '?')}, re-prefills {out['re_prefills']} "
        f"({out['re_prefill_tokens']} tokens)"))


def _serve_loadgen_template_mix(args) -> int:
    """``serve --loadgen --workload template-mix``: tenant preamble x
    template x unique suffix on a bounded worker pool, with the
    computed-vs-offered prefill tokens."""
    from .serve import run_template_mix

    _, cfg, server = _build_serve_stack(args)
    sampling = _serve_sampling(args)
    prompt_len = args.preamble_len + args.template_len + args.suffix_len
    with server:
        server.warmup(sampling, prompt_lens=(prompt_len,))
        out = run_template_mix(
            server, vocab_size=cfg.vocab_size, sessions=args.sessions,
            tenants=args.tenants, templates=args.templates,
            preamble_len=args.preamble_len, template_len=args.template_len,
            suffix_len=args.suffix_len, max_new_tokens=args.max_new_tokens,
            sampling=sampling, workers=args.workers, seed=args.seed)
    out["engine"] = _loadgen_engine(server)
    out["server_metrics"] = server.metrics_summary()
    pf = out.get("prefill", {})
    px = out.get("prefix_cache") or {}
    return _emit_report(args, out, (
        f"template-mix summary: {out['completed']} req over "
        f"{args.sessions} sessions ({args.tenants}x{args.templates} "
        f"pairs), {out.get('tokens_per_sec', '?')} tok/s, prefill "
        f"computed {pf.get('tokens_computed', '?')}/"
        f"{pf.get('tokens_offered', '?')} offered "
        f"(ratio {pf.get('compute_ratio', '?')}), prefix mode "
        f"{px.get('mode', 'n/a')} hit rate {px.get('hit_rate', 'n/a')}"))


def _serve_loadgen_kernel_sweep(args, kernels: tuple[str, ...]) -> int:
    """``serve --loadgen --decode-kernel pallas,scan``: the same closed-loop
    workload on a fresh stack (and registry) per kernel, tokens/s and
    TTFT / ITL deltas, greedy token parity, each arm's scan fallbacks."""
    import copy

    from .obs import MetricsRegistry
    from .serve import kernel_sweep

    if args.mode != "closed":
        print("error: --decode-kernel comparison is closed-loop only",
              file=sys.stderr)
        return USAGE_RC

    def make_server(kern):
        a = copy.copy(args)
        a.decode_kernel = kern
        return _build_serve_stack(a, registry=MetricsRegistry())[2]

    out = kernel_sweep(
        make_server, vocab_size=args.vocab_size, kernels=kernels,
        sessions=args.sessions,
        requests_per_session=args.requests_per_session,
        prompt_len=args.prompt_len, max_new_tokens=args.max_new_tokens,
        sampling=_serve_sampling(args), seed=args.seed)
    vs = out.get("pallas_vs_scan", {})
    _emit_report(args, out, (
        f"kernel sweep: tokens/s "
        f"{ {k: r['tokens_per_sec'] for k, r in out['kernels'].items()} }, "
        f"pallas/scan ratio {vs.get('tokens_per_sec_ratio', 'n/a')}, "
        f"p99 ITL delta {vs.get('p99_itl_delta_ms', 'n/a')} ms, "
        f"scan fallbacks {out['scan_fallbacks']}, "
        f"parity_ok {out.get('parity_ok', 'n/a')}"))
    return OK_RC if out.get("parity_ok", True) else FAIL_RC


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
    p.add_argument("--trace", type=str, default=None,
                   help="host-side span trace output (Chrome trace-event "
                        "JSON): load, setup, train, eval, checkpoint and "
                        "generate spans")
    p.add_argument("--generate-tokens", type=int, default=0,
                   help="after training, sample N continuation tokens from "
                        "the LM")
    p.add_argument("--prompt", type=str, default=None,
                   help="generation prompt text (defaults to the corpus "
                        "start)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None,
                   help="nucleus sampling mass in (0, 1]")
    p.add_argument("--greedy", action="store_true", help="argmax decoding")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


LM_DATASETS = ("ptb_char", "wikitext2", "wikitext103")


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
    if args.dataset not in LM_DATASETS and args.generate_tokens > 0:
        raise SystemExit(
            "--generate-tokens applies to the LM datasets only "
            f"(got --dataset {args.dataset})")
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
    from .utils import Tracer, set_tracer, span

    refused = _refusal(args)
    if refused:
        print(f"train: {refused}", file=sys.stderr)
        return USAGE_RC
    dev = resolve_device(args.device)
    configure_precision()
    with MetricsLogger(args.jsonl) as logger:
        tracer = None
        if args.trace:
            tracer = Tracer()
            set_tracer(tracer)
        try:
            try:
                run = _training(args, dev, logger, graph)
            except UsageError as e:
                print(f"train: {e}", file=sys.stderr)
                return USAGE_RC
            try:
                with span("train", steps=run.loop_kw.get("num_steps"),
                          backend="single"):
                    state = train_loop(run.state, run.step, run.feed,
                                       logger=logger, **run.loop_kw)
            except AnomalousTrainingError as e:
                print(f"anomaly abort: {e} (exit {ANOMALY_RC})",
                      file=sys.stderr)
                return ANOMALY_RC
            with span("eval_final"):
                final = run.eval_fn(state.params)
            logger.log({"step": state.step, **final, "note": "final"})
            if run.generate is not None:
                with span("generate", tokens=args.generate_tokens):
                    run.generate(state.params)
        finally:
            if tracer is not None:
                set_tracer(None)  # uninstall first: a failed save must not leak it
                try:
                    tracer.save(args.trace)
                except OSError as e:
                    # never mask the run's own outcome with a trace-write error
                    print(f"warning: could not write --trace file: {e}")
    return OK_RC


def _generate_text(args, logger, cfg, data, params, dev) -> None:
    """Sample ``--generate-tokens`` after training (JAX's
    ``_generate_text``): encode the prompt (the corpus start without one,
    its first 8 tokens when the prompt encodes to nothing), run the
    port's ``generate`` on the run's device with noise from a generator
    seeded ``--seed + 17``, and log and print the decoded continuation."""
    from .models.generate import generate

    level = "char" if args.dataset == "ptb_char" else "word"
    vocab = data["vocab"]
    if args.prompt:
        prompt_ids = vocab.encode_text(args.prompt, level)
        if prompt_ids.size == 0:
            prompt_ids = np.asarray(data["train"][:8], np.int32)
    else:
        prompt_ids = np.asarray(data["train"][:32], np.int32)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 17)
    out = generate(params, prompt_ids[None, :], cfg,
                   max_new_tokens=args.generate_tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, greedy=args.greedy, generator=gen,
                   device=dev)[0].cpu().numpy()
    sep = "" if level == "char" else " "
    prompt_txt = sep.join(vocab.decode(prompt_ids))
    cont_txt = sep.join(vocab.decode(out[prompt_ids.size:]))
    logger.log({
        "note": "generate", "prompt": prompt_txt, "continuation": cont_txt,
        "temperature": args.temperature, "top_k": args.top_k,
        "top_p": args.top_p, "greedy": bool(args.greedy),
    })
    print(f"--- prompt ---\n{prompt_txt}\n--- continuation ---\n{cont_txt}")


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
    from .utils import span

    seq_len = args.seq_len or 64
    B = args.batch_size
    k = args.steps_per_call
    try:
        with span("load_dataset", dataset=args.dataset):
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

    with span("setup", hidden=cfg.hidden_size, layers=cfg.num_layers):
        params = params_to(
            init_lm(torch.Generator().manual_seed(args.seed), cfg), dev)
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
                         if fused_eval else None)),
        generate=((lambda p: _generate_text(args, logger, cfg, data, p, dev))
                  if args.generate_tokens > 0 else None))


def build_distill_parser() -> argparse.ArgumentParser:
    """``distill``: train a speculative-decoding draft against a trained
    target and publish it to the model registry (``train/distill.py``);
    the JAX command's flags and defaults, and ``--device``."""
    p = argparse.ArgumentParser(
        prog="lstm_tensorspark_torch distill",
        description="distill a draft LM (H/4, 1 layer, shared vocab) "
                    "against a trained target's logits with a KL+CE "
                    "mixed loss, and publish it to the model registry "
                    "as a verified pair — the artifact `serve "
                    "--speculative` loads")
    # --- teacher (must match the producing training run) ---
    p.add_argument("--vocab-size", type=int, default=89)
    p.add_argument("--hidden-units", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--tie-embeddings", action="store_true")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--registry-dir", type=str, required=True,
                   help="model registry (serve/registry.py): the teacher "
                        "loads from here when --checkpoint-dir is not "
                        "given, and the draft publishes here as "
                        "'<--model-id>-draft'")
    p.add_argument("--model-id", type=str, default="default",
                   help="the teacher's registry id (the id the server "
                        "boots as)")
    p.add_argument("--draft-id", type=str, default=None,
                   help="publish the draft under this id instead of "
                        "'<--model-id>-draft'")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="restore the teacher from a training checkpoint "
                        "(step_<N>.pt of this package or step_<N>.msgpack "
                        "of the JAX package) instead of the registry")
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=OPTIMIZERS,
                   help="the training run's optimizer (a checkpoint's "
                        "optimizer state must match it; the draft trains "
                        "with --distill-optimizer)")
    p.add_argument("--learning-rate", type=float, default=1.0,
                   help="accepted as the JAX command takes it (restore "
                        "only)")
    # --- corpus (the logit-harvest stream) ---
    p.add_argument("--data-path", type=str, default=None,
                   help="corpus directory (falls back to the dataset's "
                        "synthetic stand-in)")
    p.add_argument("--dataset", type=str, default="ptb_char",
                   choices=list(LM_DATASETS))
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=32)
    # --- distillation ---
    p.add_argument("--steps", type=int, default=200,
                   help="draft optimizer steps (each scores one [B,T] "
                        "window through the teacher first)")
    p.add_argument("--alpha", type=float, default=0.5,
                   help="KL(teacher||student) weight in [0,1]; 1-alpha "
                        "weights the hard-label cross-entropy")
    p.add_argument("--distill-temperature", type=float, default=2.0,
                   help="softmax temperature of the KL term (Hinton tau; "
                        "the loss scales by tau^2)")
    p.add_argument("--distill-optimizer", type=str, default="adam",
                   choices=OPTIMIZERS)
    p.add_argument("--distill-lr", type=float, default=1e-3)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--jsonl", type=str, default=None,
                   help="metrics JSONL path for the distill run")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def _run_distill(argv) -> int:
    """``distill``: the teacher from ``--checkpoint-dir`` (else the
    registry's ``--model-id``, its fingerprint checked against the model
    flags), the draft trained over the corpus on ``--device``, published as
    ``<--model-id>-draft``; prints JAX's ``{"distill": {...}}`` record, with
    the kernels the run launched (``launch_counts``)."""
    from .data import get_dataset, lm_batch_stream
    from .device import configure_precision, resolve_device
    from .kernels import LaunchCounts
    from .models.lstm_lm import LMConfig, init_lm
    from .serve.registry import ModelRegistry, RegistryError, config_fingerprint
    from .train import MetricsLogger
    from .train.distill import distill, publish_draft

    args = build_distill_parser().parse_args(argv)
    dev = resolve_device(args.device)
    configure_precision()
    cfg = LMConfig(vocab_size=args.vocab_size, hidden_size=args.hidden_units,
                   num_layers=args.num_layers,
                   tie_embeddings=args.tie_embeddings,
                   compute_dtype=args.compute_dtype)
    registry = ModelRegistry(args.registry_dir)
    template = init_lm(torch.Generator().manual_seed(args.seed), cfg)
    if args.checkpoint_dir:
        tparams = _checkpoint_params(args, template, cmd="distill")
    else:
        try:
            meta, tparams = registry.load_params(args.model_id, template)
        except (RegistryError, ValueError, KeyError) as e:
            raise SystemExit(
                f"cannot load teacher {args.model_id!r} from "
                f"{args.registry_dir}: {e} (publish one, or pass "
                "--checkpoint-dir)")
        if (meta.get("config_hash")
                and meta["config_hash"] != config_fingerprint(cfg)):
            raise SystemExit(
                f"teacher {args.model_id} v{meta['version']} was "
                f"published for config {meta['config_hash']}, the model "
                f"flags describe {config_fingerprint(cfg)} — align the "
                "flags with the producing run")
    try:
        ds = get_dataset(args.dataset, args.data_path)
    except ValueError as e:
        raise SystemExit(f"distill: {e}")
    if len(ds["vocab"]) > cfg.vocab_size:
        raise SystemExit(
            f"corpus vocab ({len(ds['vocab'])}) exceeds --vocab-size "
            f"({cfg.vocab_size}); the teacher cannot score tokens "
            "outside its embedding")
    with MetricsLogger(args.jsonl) as logger:
        dparams, dcfg = distill(
            tparams, cfg, lm_batch_stream(ds["train"], args.batch_size,
                                          args.seq_len),
            num_steps=args.steps, alpha=args.alpha,
            temperature=args.distill_temperature,
            optimizer=args.distill_optimizer, learning_rate=args.distill_lr,
            seed=args.seed, log_every=args.log_every, logger=logger,
            device=dev)
    meta = publish_draft(registry, dparams, dcfg, cfg,
                         teacher_id=args.model_id, draft_id=args.draft_id)
    print(json.dumps({
        "distill": {
            "draft": meta["model"], "version": meta["version"],
            "hidden_size": dcfg.hidden_size,
            "num_layers": dcfg.num_layers,
            "config_hash": meta["config_hash"],
            "parent": meta["parent"],
            "payload_bytes": meta["payload_bytes"],
            "steps": args.steps,
            "launch_counts": {c.name: c.kernel for c in LaunchCounts.every()
                              if c.kernel},
        }
    }))
    return OK_RC


def main(argv=None, *, graph: bool = True) -> int:
    """The command line. ``graph=False`` runs every train call eagerly on
    the card too, instead of replaying its CUDA graph: the form the card's
    smoke run compares the captured runs with (not a flag)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "train":
        return _run_train(build_train_parser().parse_args(argv[1:]), graph)
    if argv and argv[0] == "distill":
        return _run_distill(argv[1:])
    if not argv or argv[0] != "serve":
        print("usage: python -m lstm_tensorspark_torch {train,serve,distill} "
              "[flags]; see train --help, serve --help, distill --help",
              file=sys.stderr)
        return USAGE_RC
    args = build_serve_parser().parse_args(argv[1:])
    from .utils import Tracer, set_tracer

    tracer = None
    if args.trace:
        tracer = Tracer()
        set_tracer(tracer)
    try:
        if args.selftest:
            return _serve_selftest(args)
        if args.loadgen:
            return _serve_loadgen(args)
        return _serve_http(args)
    finally:
        if tracer is not None:
            set_tracer(None)
            try:
                tracer.save(args.trace)
            except OSError as e:
                print(f"warning: could not write --trace file: {e}")
