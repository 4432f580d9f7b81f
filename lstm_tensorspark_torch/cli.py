"""Command line of the port: ``python -m lstm_tensorspark_torch serve ...``.

- ``serve --selftest`` decodes ``--sessions`` concurrent sessions through
  the full server path and checks that the greedy tokens equal the plain
  ``models/generate.generate`` on the CPU for the same weights (rc 0 on
  PASS, 1 on a mismatch or a request error);
- ``serve --http`` warms the engine and serves ``POST /v1/generate``,
  ``GET /healthz`` and ``GET /v1/stats`` until interrupted.

Weights are drawn from ``--seed`` (serving a trained checkpoint waits for
the training part of the port). ``--device`` defaults to ``cuda`` and
fails without a card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading

import numpy as np
import torch

from .exit_codes import FAIL_RC, OK_RC, USAGE_RC

DEFAULT_WINDOW_LADDER = (1, 4, 8)


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


def _build_serve_stack(args):
    """(cpu params, cfg, server) from the serve flags."""
    from .models.lstm_lm import LMConfig, init_lm
    from .serve import ServeEngine, ServeServer

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
    server = ServeServer(engine, max_active=args.max_active,
                         queue_size=args.queue_size,
                         window_ladder=_parse_window_ladder(args.decode_window))
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
        **stats["batcher"],
    }))
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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "serve":
        print("usage: python -m lstm_tensorspark_torch serve "
              "(--selftest | --http) [flags]; see serve --help",
              file=sys.stderr)
        return USAGE_RC
    args = build_serve_parser().parse_args(argv[1:])
    if args.selftest:
        return _serve_selftest(args)
    return _serve_http(args)
