#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``lstm_tensorspark_torch``).

Run from the root of a checkout on a machine with one NVIDIA card::

    python3 chip_smoke.py

Phases (each one fails the run):

1. versions, and the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``csrc/`` (``nvcc``, one
   process per source, all at once);
3. hold the decode-window kernel against its plain PyTorch version on the
   card, at config 1's shape (L=1, H=128, V=50; B in {1, 8, 16}, 8 being
   the batch bucket the serve burst dispatches; K in
   {1, 4, 8}; greedy and temperature with shared noise; EOS, budget-end and
   dead rows) and at config 3's width (L=2, H=650, V=33,278; B=4; K=4),
   plus config 5's width (L=4, H=1024) with a small head for the shared
   memory opt-in: tokens identical, h/c within 1e-5; time config 1 and 3
   with CUDA events;
4. serve: boot the HTTP server on 127.0.0.1 at config 1 full width with
   seeded weights, send 6 concurrent greedy ``/v1/generate`` requests
   (prompt lengths 3-40, 32 new tokens, one with ``eos_id``) and check the
   tokens against the plain ``generate`` on the CPU, that the window
   kernel's launch count rose during the run and that no decode ran the
   plain version on the card; then a prompt id outside the vocabulary
   must get a 400, and the burst after it must be served identical;
5. hold the LSTM recurrence kernels (``csrc/lstm_fwd.cu``,
   ``csrc/lstm_bwd.cu``) against their plain PyTorch versions at config 1
   (B=64, T=64, H=128) and config 3's width (B=32, T=70, H=650), with and
   without a mask, and at a serve prefill batch (B=3, T=5, H=128, masked),
   from non-zero carries, the forward with and without residuals; time
   config 1 in turns (plain, kernel, kernel, plain) with CUDA events and
   under ``torch.profiler``, beside cuDNN's ``torch.nn.LSTM`` on the same
   shapes (the yardstick; the port never calls it) and the bound, each
   time also per step;
6. train config 1 through the CLI entry (``cli.main(["train", ...])``):
   the first 10 losses on the card against the same run on the CPU (plain
   versions, same seed and batches), and 5 of a 2-layer stack, then 300 steps with an eval every 100
   whose kernel launch counts must equal steps × layers (+ the eval
   forwards), steps/s and tokens/s, and the device idle share over 20
   steps under ``torch.profiler``;
7. hold the residentx kernels (``csrc/lstmx_fwd.cu``, ``csrc/lstmx_bwd.cu``)
   against their plain versions in all four roles — one direction and the
   stacked two directions of a bi-LSTM layer, forward and backward — at
   config 2 (B=32 per direction, T=400, D=H=256), masked with the IMDB
   stand-in's lengths and unmasked, at the LM's ``--seq-len 256`` shape
   (B=64, T=256, D=H=128; one direction) and at an awkward shape (B=8,
   T=257, D=72, H=200); time each role at the shape its launches in phase
   8 come from in turns (plain, kernel, kernel, plain) with CUDA events and
   under ``torch.profiler`` (the backward's chain and its z rebuild
   apart), beside cuDNN's ``torch.nn.LSTM`` (bidirectional for the
   stacked roles) and the bound, each time also per step; and time the
   stacked pair under the card's plan against the other row cut of each
   kernel;
8. train config 2 through the CLI: the first 10 losses on the card at
   ``--dropout 0``, without and with ``--remat-chunk 50``, against the same
   run on the CPU (without remat: the plain scan's values do not depend
   on it); 300 steps at ``--dropout 0.2`` with an eval every 100,
   whose launch counts must equal the prediction; the LM at
   ``--seq-len 256`` (the single-direction residentx pair) for 10 steps
   against the CPU; and the device idle share over 20 config-2 steps under
   ``torch.profiler``;
9. hold the tiled kernels (``csrc/lstm_tiled_fwd.cu``,
   ``csrc/lstm_tiled_bwd.cu``) against their plain versions at config 5's
   per-chip shard (B=16, T=128, H=1024), at B=64 with H=1024 and at config
   3's width (B=32, T=70, H=650), masked and unmasked, from non-zero
   carries, the forward with and without residuals; print their plans;
   time both at config 5's shard in turns (plain, kernel, kernel, plain)
   with CUDA events and under ``torch.profiler``, beside cuDNN's
   ``torch.nn.LSTM`` and the bound; and time the tiled pair against the
   resident pair at config 3's width, the route rule's boundary;
10. train config 5's model (4 x 1024 word LM on the WikiText-103
   stand-in, B=16, T=128, Adam 1e-3, clip 1.0, stateful, f32) through the
   CLI: the first 5 losses at ``--dropout 0`` on the card, without and
   with ``--remat-chunk 32``, against one CPU run; 200 steps at
   ``--dropout 0.2`` with an eval every 100, whose tiled launch counts must
   equal the prediction while every other recurrence counter stays at 0;
   steps/s, tokens/s, eval perplexity, and the device idle share over 20
   steps under ``torch.profiler``;
11. hold the speculative window kernel (``csrc/spec_window.cu``) against
   its plain version at config 1 (target L=1, H=128, V=50; the
   ``draft_config`` draft, H=32; B in {1, 8, 16}, k_draft in {1, 2, 4}; a
   random, an all-reject and an all-accept draft; EOS, budget-end and dead
   rows; a tied-head pair at B=8) and at config 3's width (L=2, H=650,
   V=33,278, draft H=162, B=4, k_draft=4): tokens, next, alive and
   remaining identical, the four carry arrays within 1e-5; time config 1
   (B=16, k_draft=4) and config 3 in turns (plain, kernel, kernel, plain)
   with CUDA events and under ``torch.profiler``, beside the bound and the
   plain decode window of W = k_draft + 1 steps;
12. speculative serving: boot the HTTP server at config 1 with seeded
   weights, plain, then ``speculative=True`` (ladder 2, 4) with the random
   ``draft_config`` draft and with the all-accept draft (the target
   itself); send phase 4's 6 concurrent greedy requests to each and check
   the tokens against the plain ``generate`` on the CPU, that the spec
   kernel's launches equal the spec windows dispatched, that no window ran
   the plain version, that the prefills launched ``lstm_fwd`` and that no
   draft prefill failed; print the mean accepted length, tokens/s, TTFT,
   max inter-token gap and the device idle share under ``torch.profiler``.

The last lines are the kernel report (one JSON object), the card's
``name, power.limit`` line, and ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, without a card or without the package.
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

TOL = 1e-5
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM float32, outside the tensor cores
CONFIG1 = dict(vocab=50, hidden=128, layers=1)
CONFIG3 = dict(vocab=33278, hidden=650, layers=2)
# config 5's width (4 x 1024) with a small head: its 53 KB of shared memory
# takes the kernel's opt-in path above the 48 KB default
CONFIG5_GATES = dict(vocab=1000, hidden=1024, layers=4)
# the recurrence kernels' shapes: config 1's training window, and config 3's
# width (a hidden size that is no multiple of a block's share)
LSTM_CONFIG1 = dict(B=64, T=64, H=128)
LSTM_CONFIG3 = dict(B=32, T=70, H=650)
# a serve prefill batch at config 1's width: 3 prompts in a length bucket
# of 5, right-padded (the resident forward alone, no residuals)
LSTM_PREFILL = dict(B=3, T=5, H=128)
# values (h, c, bounded by the gates) are held to 1e-5 absolute; the
# pre-activations z and the gradients (dz, dh0, dc0) are sums of H or 4H
# products, so their float32 rounding scales with their size: held to
# 1e-5 of max(1, max |reference|)
LSTM_TOL = 1e-5
# ten SGD steps at lr 0.5 compound the float32 rounding of differently
# ordered sums (kernel vs the CPU's plain loop) into the losses
TRAIN_LOSS_TOL = 1e-4
TRAIN_FLAGS = ["train", "--dataset", "ptb_char", "--hidden-units", "128",
               "--num-layers", "1", "--batch-size", "64", "--seq-len", "64",
               "--learning-rate", "0.5", "--stateful", "--compute-dtype",
               "float32"]
TRAIN_STEPS, EVAL_EVERY, EVAL_BATCHES = 300, 100, 8
# config 2: the bi-LSTM classifier on the IMDB stand-in (B=32, T=400,
# E=H=256, V=113), Adam 1e-3, clip 1.0
CONFIG2 = dict(B=32, T=400, D=256, H=256)
CONFIG2_FLAGS = ["train", "--dataset", "imdb", "--hidden-units", "256",
                 "--num-layers", "1", "--batch-size", "32", "--seq-len",
                 "400", "--optimizer", "adam", "--learning-rate", "1e-3",
                 "--clip-norm", "1.0", "--compute-dtype", "float32"]
CONFIG2_STEPS, CONFIG2_EVAL_EVERY = 300, 100
AWKWARD = dict(B=8, T=257, D=72, H=200)
# config 1's LM at --seq-len 256 (E=H=128): the single-direction
# residentx pair
LM256 = dict(B=64, T=256, D=128, H=128)
# config 5's model (4 x 1024 word LM, T=128) at its per-chip batch (a global
# batch of 256 over 16 chips): every layer runs the tiled pair
CONFIG5 = dict(B=16, T=128, H=1024, L=4)
LSTM_CONFIG5 = dict(B=16, T=128, H=1024)
LSTM_B64 = dict(B=64, T=128, H=1024)
CONFIG5_FLAGS = ["train", "--dataset", "wikitext103", "--hidden-units",
                 "1024", "--num-layers", "4", "--batch-size", "16",
                 "--seq-len", "128", "--optimizer", "adam", "--learning-rate",
                 "1e-3", "--clip-norm", "1.0", "--stateful",
                 "--compute-dtype", "float32", "--logits-dtype", "float32"]
CONFIG5_FIRST = 5
CONFIG5_STEPS, CONFIG5_EVAL_EVERY, CONFIG5_EVAL_BATCHES = 200, 100, 8


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def make_model(torch, tlm, gen_seed, vocab, hidden, layers, device):
    cfg = tlm.LMConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers)
    params = tlm.init_lm(torch.Generator().manual_seed(gen_seed), cfg)
    return cfg, params, tlm.params_to(params, device)


def window_inputs(torch, cd, weights, cfg, B, K, greedy, seed, device,
                  edge_rows):
    """Carries, latches and noise for one window; with ``edge_rows`` row 0
    gets an EOS id it really emits, row 1 a budget ending mid-window, row 2
    is dead on entry."""
    g = torch.Generator().manual_seed(seed)
    L, H, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    h = (torch.randn((L, B, H), generator=g) * 0.5).to(device)
    c = (torch.randn((L, B, H), generator=g) * 0.5).to(device)
    tok = torch.randint(0, V, (B,), generator=g, dtype=torch.int32).to(device)
    noise = None
    if not greedy:
        u = torch.rand((K, B, V), generator=g).clamp_min(1e-38)
        noise = (-torch.log(-torch.log(u))).to(device)
    alive = torch.ones(B, dtype=torch.int32, device=device)
    rem = torch.full((B,), K + 3, dtype=torch.int32, device=device)
    eos = torch.full((B,), -1, dtype=torch.int32, device=device)
    if edge_rows:
        probe = cd.decode_window_reference(
            weights, h, c, tok, alive, rem, eos, noise, window=K,
            temperature=0.7, greedy=greedy)[2]
        eos[0] = probe[K // 2, 0]
        if B > 2:
            rem[1] = max(1, K // 2)
            alive[2] = 0
            rem[2] = 0
    return h, c, tok, alive, rem, eos, noise


def compare(torch, cd, weights, inputs, K, greedy, label):
    """Kernel vs plain version on the same inputs; returns the max abs h/c
    difference and the number of live row-steps (non-PAD tokens)."""
    args = dict(window=K, temperature=0.7, greedy=greedy)
    got = cd.decode_window(weights, *inputs, **args)
    ref = cd.decode_window_reference(weights, *inputs, **args)
    torch.cuda.synchronize()
    names = ("h", "c", "tokens", "next", "alive", "remaining")
    for name, a, b in zip(names[2:], got[2:], ref[2:]):
        if not torch.equal(a, b):
            fail(f"{label}: kernel {name} differ from the plain version:\n"
                 f"kernel {a.tolist()}\nplain  {b.tolist()}")
    err = max(float((got[0] - ref[0]).abs().max()),
              float((got[1] - ref[1]).abs().max()))
    if err > TOL:
        fail(f"{label}: h/c differ by {err:.3e} > {TOL}")
    return err, int((got[2] != cd.PAD_TOKEN).sum())


def time_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(torch, fn, calls=None):
    """Device-side view of ``fn()`` from ``torch.profiler``: (device busy
    ms summed over all kernels and copies, wall ms, {name: device ms},
    {name: events recorded}) — or None when the profiler records no device
    time. The profiler can miss the first launches of a window, so a
    per-launch time divides by the events recorded, not by the calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, counts = {}, {}
    for evt in prof.key_averages():
        # device-side events only (kernels, copies): the CPU operators that
        # launched them also report their children's device time, and
        # summing both would count every kernel twice
        if not str(evt.device_type).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            by_name[evt.key] = us / 1e3
            counts[evt.key] = evt.count
    if not by_name:
        return None
    return sum(by_name.values()), wall * 1e3, by_name, counts


def bound(cfg, B, K, row_steps, sampled):
    """Least time for one window: the larger of bytes over HBM bandwidth
    (each input read once, each output written once; embedding rows as
    gathered) and float32 FLOPs over the card's peak."""
    L, H, V, E = cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.embed
    weights = sum(((E if l == 0 else H) + H) * 4 * H + 4 * H for l in range(L))
    weights += H * V + V
    emb_rows = min(row_steps, V) * E
    floats = weights + emb_rows + 4 * L * B * H + (K * B * V if sampled else 0)
    ints = 4 * B + K * B + 3 * B
    nbytes = 4 * (floats + ints)
    per_step = 2 * (sum(((E if l == 0 else H) + H) * 4 * H
                        for l in range(L)) + H * V)
    flops = row_steps * per_step
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, tlm, tgen, cd, device):
    print("== phase 3: decode-window kernel vs plain version", flush=True)
    max_err = 0.0
    timings = {}
    for name, spec, cases, timed in (
            ("config1", CONFIG1,
             [(B, K, g) for B in (1, 8, 16) for K in (1, 4, 8)
              for g in (True, False)], (16, 8)),
            ("config3", CONFIG3, [(4, 4, True), (4, 4, False)], (4, 4)),
            ("config5-gates", CONFIG5_GATES, [(2, 2, True)], None)):
        cfg, _, params = make_model(torch, tlm, 1, device=device, **spec)
        weights = cd.decode_weights(params, tgen.fuse_layers(params, cfg),
                                    cfg.tie_embeddings)
        for i, (B, K, greedy) in enumerate(cases):
            inputs = window_inputs(torch, cd, weights, cfg, B, K, greedy,
                                   seed=100 + i, device=device,
                                   edge_rows=B > 1)
            err, _ = compare(torch, cd, weights, inputs, K, greedy,
                             f"{name} B={B} K={K} greedy={greedy}")
            max_err = max(max_err, err)
            print(f"  {name} L={cfg.num_layers} H={cfg.hidden_size} "
                  f"V={cfg.vocab_size} B={B} K={K} greedy={greedy}: tokens "
                  f"identical, max |dh|,|dc| = {err:.3e}", flush=True)
        if timed is None:
            continue
        B, K = timed
        inputs = window_inputs(torch, cd, weights, cfg, B, K, True,
                               seed=7, device=device, edge_rows=False)
        _, row_steps = compare(torch, cd, weights, inputs, K, True, name)
        args = dict(window=K, temperature=1.0, greedy=True)
        iters = 200 if name == "config1" else 20

        def kernel():
            return cd.decode_window(weights, *inputs, **args)

        def plain():
            return cd.decode_window_reference(weights, *inputs, **args)

        # in turns (plain, kernel, kernel, plain) so drift hits both alike
        p1 = time_ms(torch, plain, iters)
        k1 = time_ms(torch, kernel, iters)
        k2 = time_ms(torch, kernel, iters)
        p2 = time_ms(torch, plain, iters)
        bound_ms, bound_by = bound(cfg, B, K, row_steps, sampled=False)
        timings[name] = dict(B=B, K=K, kernel_ms=(k1 + k2) / 2,
                             plain_ms=(p1 + p2) / 2, bound_ms=bound_ms,
                             bound_by=bound_by, row_steps=row_steps)
        print(f"  {name} B={B} K={K} greedy: kernel_ms "
              f"{timings[name]['kernel_ms']:.4f} ({k1:.4f}, {k2:.4f}), "
              f"plain_ms {timings[name]['plain_ms']:.4f} ({p1:.4f}, "
              f"{p2:.4f}), bound_ms {bound_ms:.6f} ({bound_by}), launches "
              f"so far {cd.counts.kernel}", flush=True)
        for label, fn in (("kernel", kernel), ("plain", plain)):
            prof = device_profile(torch, lambda: [fn() for _ in range(20)])
            if prof is None:
                print(f"  {name} {label}: the profiler recorded no device "
                      "time (device busy not measured)", flush=True)
                continue
            busy, wall, by_name, _ = prof
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
            print(f"  {name} {label} x20 under torch.profiler: device busy "
                  f"{busy / 20:.4f} ms of {wall / 20:.4f} ms wall per call; "
                  "top: " + "; ".join(f"{k[:48]} {v / 20:.4f} ms"
                                      for k, v in top), flush=True)
    return max_err, timings


def post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def serve_phase(torch, tlm, tgen, cd, serve, device):
    print("== phase 4: serve config 1 over HTTP", flush=True)
    import numpy as np

    cfg, params_cpu, _ = make_model(torch, tlm, 0, device="cpu", **CONFIG1)
    engine = serve.ServeEngine(params_cpu, cfg, device=device, num_slots=32,
                               rng_seed=0)
    server = serve.ServeServer(engine, max_active=16)
    rng = np.random.RandomState(0)
    lens = (3, 9, 17, 24, 33, 40)
    prompts = [rng.randint(0, cfg.vocab_size, size=t).tolist() for t in lens]
    n_new = 32
    refs = [tgen.generate(params_cpu, [p], cfg, max_new_tokens=n_new,
                          greedy=True, device="cpu")[0, len(p):].tolist()
            for p in prompts]
    # request 5's eos_id is a token its greedy run first emits at step 8 or
    # later, so the served request stops inside a decode window (on the
    # kernel's EOS latch), not at the token prefill samples
    eos_at = next((i for i in range(8, n_new) if refs[5][i] not in refs[5][:i]),
                  None)
    if eos_at is None:
        fail(f"no token of {refs[5]} first appears at step 8 or later")
    eos = refs[5][eos_at]
    expect = [list(r) for r in refs]
    expect[5] = refs[5][:eos_at + 1]
    t0 = time.perf_counter()
    n = server.warmup(prompt_lens=lens)
    torch.cuda.synchronize()
    print(f"  warm-up: {n} dispatches in {time.perf_counter() - t0:.2f} s",
          flush=True)
    httpd = serve.make_http_server(server, "127.0.0.1", 0)
    port = httpd.server_address[1]
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    def burst():
        """The 6 requests at once; returns (results, wall seconds)."""
        results = [None] * len(prompts)

        def run(i):
            body = {"prompt": prompts[i], "max_new_tokens": n_new,
                    "greedy": True}
            if i == 5:
                body["eos_id"] = eos
            results[i] = post(port, body)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        if any(t.is_alive() for t in threads):
            fail("a request did not finish")
        for i, r in enumerate(results):
            if r is None or r[0] != 200:
                fail(f"request {i} failed: {r}")
            if r[1]["tokens"] != expect[i]:
                fail(f"request {i}: served tokens {r[1]['tokens']} != plain "
                     f"generate on the CPU {expect[i]}")
        return results, time.perf_counter() - t0

    try:
        with server:
            cd.counts.reset()
            results, wall = burst()
            launches, plain_windows = cd.counts.kernel, cd.counts.reference
            stats = server.stats()
            # the same burst again under the profiler: where the serve
            # path's device time goes, and how idle the card is
            prof = device_profile(torch, burst)
            # a prompt id outside the vocabulary is refused (400) before it
            # reaches the card, where its gather would be a device-side
            # assert; the server then serves the burst again
            bad = post(port, {"prompt": [1, cfg.vocab_size, 2],
                              "max_new_tokens": 4, "greedy": True})
            if bad[0] != 400:
                fail(f"an out-of-range prompt id got {bad}, not a 400")
            burst()
            torch.cuda.synchronize()
    finally:
        httpd.shutdown()
        httpd.server_close()
        http_thread.join(30)
    if launches < 1:
        fail("the serve run launched the decode-window kernel no time")
    if plain_windows != 0 or stats["engine"]["decode_kernel"] != "cuda":
        fail(f"the engine ran {plain_windows} plain decode windows on the card")
    if not sum(stats["batcher"]["windows_dispatched"].values()):
        fail("the serve run dispatched no multi-token decode window")
    # the tokens matched expect[5], so request 5 stopped at its eos_id after
    # eos_at tokens that decode windows produced on the card
    print(f"  an out-of-range prompt id got 400 ({bad[1]['error']}); the "
          f"burst after it was served identical again", flush=True)
    print(f"  request 5 stopped on eos_id {eos} at step {eos_at} of {n_new}: "
          f"{eos_at} of its tokens came from decode windows", flush=True)
    tokens = sum(len(r[1]["tokens"]) for r in results)
    print(f"  6 concurrent requests: tokens identical to the plain generate "
          f"on the CPU; {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tokens/s; kernel launches {launches} "
          f"({launches / tokens:.3f} per token); windows "
          f"{stats['batcher']['windows_dispatched']}", flush=True)
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    itl = sorted(r[1]["max_itl_ms"] or 0.0 for r in results)
    print(f"  ttft_ms per request {ttft} (median {ttft[len(ttft) // 2]}); "
          f"max_itl_ms per request {itl}", flush=True)
    if prof is None:
        print("  serve under torch.profiler: no device time recorded "
              "(device idle share not measured)", flush=True)
    else:
        busy, pwall, by_name, _ = prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"  serve burst under torch.profiler: device busy {busy:.3f} ms "
              f"of {pwall:.3f} ms wall (idle share "
              f"{1 - busy / pwall:.3f}); top: "
              + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top), flush=True)
    return launches, tokens


def lstm_inputs(torch, B, T, H, masked, seed, device):
    """Seeded inputs of one layer's recurrence: xproj, U, h0, c0, mask (or
    None) and the backward's cotangents dys, dhT, dcT, on ``device``."""
    g = torch.Generator().manual_seed(seed)
    G = 4 * H
    xproj = torch.randn(T, B, G, generator=g)
    U = torch.randn(H, G, generator=g) / H ** 0.5
    h0 = torch.randn(B, H, generator=g) * 0.5
    c0 = torch.randn(B, H, generator=g) * 0.5
    mask = None
    if masked:  # right padding of assorted lengths
        lens = torch.randint(1, T + 1, (B,), generator=g)
        mask = (torch.arange(T)[:, None] < lens[None, :]).float()
    dys = torch.randn(T, B, H, generator=g)
    dhT = torch.randn(B, H, generator=g)
    dcT = torch.randn(B, H, generator=g)

    def dev(t):
        return None if t is None else t.to(device).contiguous()

    return [dev(t) for t in (xproj, U, h0, c0, mask)], \
        [dev(t) for t in (dys, dhT, dcT)]


def held(torch, name, got, ref, label, scaled):
    """max |got - ref|, failing the run above LSTM_TOL (scaled by the
    reference's size for sums of products)."""
    err = float((got - ref).abs().max())
    tol = LSTM_TOL * (max(1.0, float(ref.abs().max())) if scaled else 1.0)
    if not err <= tol:
        fail(f"{label}: kernel {name} differs from the plain version by "
             f"{err:.3e} > {tol:.3e}")
    return err


def lstm_bound(B, T, H, kind, masked=False):
    """Least time of one call: the larger of the bytes it must move (each
    input read once, each output written once) over HBM bandwidth and its
    products' FLOPs (2·T·B·H·4H) over the float32 peak."""
    G = 4 * H
    if kind == "fwd":  # xproj, U, h0, c0 in; ys, hT, cT, z, cs out
        floats = T * B * G + H * G + 2 * B * H + T * B * H + 2 * B * H \
            + T * B * G + T * B * H
    else:  # z, dys, cs, c0, U, dhT, dcT in; dz, dh0, dc0 out
        floats = T * B * G + 2 * T * B * H + B * H + G * H + 2 * B * H \
            + T * B * G + 2 * B * H
    nbytes = 4 * (floats + (T * B if masked else 0))
    flops = 2 * T * B * H * G
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def cudnn_yardstick(torch, forward, layer_scan, inputs, cots):
    """cuDNN's ``torch.nn.LSTM`` on one layer at the same B, T, H: input
    weights W [H, 4H] and bias b drawn here, U copied across (the gate order
    i, f, g, o is the same in both; ``bias_hh`` is 0), TF32 off. It computes
    the same function as the kernel ``forward`` fed ``xproj = x @ W + b``,
    plus that input product; its backward also gives dW, dU, db and dx.
    Returns (forward ms, backward-alone ms, forward + backward ms, max |ys
    - ys of the forward kernel|, and the port's whole layer forward +
    backward ms: ``layer_scan`` through both kernels and the matmuls
    around them, the same function as cuDNN's forward + backward)."""
    xproj, U, h0, c0, _ = inputs
    dys, dhT, dcT = cots
    T, B, G = xproj.shape
    H = G // 4
    dev = xproj.device
    g = torch.Generator().manual_seed(5)
    W = (torch.randn(H, G, generator=g) / H ** 0.5).to(dev)
    b = (torch.randn(G, generator=g) * 0.1).to(dev)
    x = torch.randn(T, B, H, generator=g).to(dev)
    lstm = torch.nn.LSTM(H, H).to(dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(W.T)
        lstm.weight_hh_l0.copy_(U.T)
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    xg = x.clone().requires_grad_()
    hc = (h0[None].clone().requires_grad_(), c0[None].clone().requires_grad_())
    params = [xg, *hc, *lstm.parameters()]
    grads_out = [dys, dhT[None], dcT[None]]

    def fwd():
        return lstm(xg, hc)

    ys, (hT, cT) = fwd()
    kys = forward((x @ W + b).contiguous(), U, h0, c0)[0]
    torch.cuda.synchronize()
    diff = float((ys.detach() - kys).abs().max())

    def bwd():
        return torch.autograd.grad([ys, hT, cT], params, grads_out,
                                   retain_graph=True)

    def both():
        y, (h, c) = fwd()
        return torch.autograd.grad([y, h, c], params, grads_out)

    from lstm_tensorspark_torch.ops.lstm_cell import LSTMParams

    gates = [t.contiguous().requires_grad_()
             for t in (*W.split(H, 1), *U.split(H, 1), *b.split(H))]
    lp = LSTMParams(*gates)
    xs = x.transpose(0, 1).contiguous().requires_grad_()
    h0g, c0g = h0.clone().requires_grad_(), c0.clone().requires_grad_()
    port_out = [dys.transpose(0, 1), dhT, dcT]

    def port_both():
        (h, c), y = layer_scan(lp, xs, (h0g, c0g))
        return torch.autograd.grad([y, h, c], [*gates, xs, h0g, c0g],
                                   port_out)

    return (time_ms(torch, fwd, 50), time_ms(torch, bwd, 50),
            time_ms(torch, both, 50), diff, time_ms(torch, port_both, 50))


def lstm_kernel_phase(torch, cl, device):
    print("== phase 5: LSTM recurrence kernels vs plain versions", flush=True)
    errs = {"fwd": 0.0, "bwd": 0.0}
    for name, spec in (("config1", LSTM_CONFIG1), ("config3", LSTM_CONFIG3),
                       ("prefill", LSTM_PREFILL)):
        B, T, H = spec["B"], spec["T"], spec["H"]
        for masked in ((True,) if name == "prefill" else (False, True)):
            label = f"{name} B={B} T={T} H={H} mask={masked}"
            inputs, (dys, dhT, dcT) = lstm_inputs(torch, B, T, H, masked,
                                                  seed=H + masked,
                                                  device=device)
            got = cl.lstm_forward(*inputs, save_residuals=True)
            bare = cl.lstm_forward(*inputs)
            ref = cl.lstm_forward_reference(*inputs, save_residuals=True)
            torch.cuda.synchronize()
            e = {}
            for n, a, r in zip(("ys", "hT", "cT", "z", "cs"), got, ref):
                e[n] = held(torch, n, a, r, label, scaled=n == "z")
            for n, a, r in zip(("ys", "hT", "cT"), bare, got):
                if not torch.equal(a, r):
                    fail(f"{label}: the forward without residuals gives "
                         f"other {n} than with them")
            ys, hT, cT, z, cs = ref
            c_prev = torch.cat([inputs[3][None], cs[:-1]])
            bgot = cl.lstm_backward(z, inputs[3], cs, dys, inputs[1], dhT,
                                    dcT, inputs[4])
            bref = cl.lstm_backward_reference(z, c_prev, dys, inputs[1], dhT,
                                              dcT, inputs[4])
            torch.cuda.synchronize()
            for n, a, r in zip(("dz", "dh0", "dc0"), bgot, bref):
                e[n] = held(torch, n, a, r, label, scaled=True)
            errs["fwd"] = max(errs["fwd"], *(e[n] for n in
                                             ("ys", "hT", "cT", "z", "cs")))
            errs["bwd"] = max(errs["bwd"], e["dz"], e["dh0"], e["dc0"])
            print(f"  {label}: max |d| " + ", ".join(
                f"{n} {v:.2e}" for n, v in e.items()), flush=True)
        print(f"  {name} plans: fwd {cl.plan('fwd', B, H)}; "
              f"bwd {cl.plan('bwd', B, H)}", flush=True)

    # timing at config 1, the training path's shapes (forward with
    # residuals, no mask)
    B, T, H = LSTM_CONFIG1["B"], LSTM_CONFIG1["T"], LSTM_CONFIG1["H"]
    inputs, (dys, dhT, dcT) = lstm_inputs(torch, B, T, H, False, seed=1,
                                          device=device)
    _, _, _, z, cs = cl.lstm_forward(*inputs, save_residuals=True)
    fns = {
        "fwd": (lambda: cl.lstm_forward(*inputs, save_residuals=True),
                lambda: cl.lstm_forward_reference(*inputs,
                                                  save_residuals=True)),
        "bwd": (lambda: cl.lstm_backward(z, inputs[3], cs, dys, inputs[1],
                                         dhT, dcT),
                lambda: cl.lstm_backward_reference(
                    z, torch.cat([inputs[3][None], cs[:-1]]), dys, inputs[1],
                    dhT, dcT)),
    }
    lib_fwd, lib_bwd, lib_both, lib_diff, port_both = cudnn_yardstick(
        torch, cl.lstm_forward, cl.cuda_lstm_scan, inputs, (dys, dhT, dcT))
    print(f"  cuDNN torch.nn.LSTM (yardstick, input width {H}): forward "
          f"{lib_fwd:.4f} ms, backward alone {lib_bwd:.4f} ms, forward + "
          f"backward {lib_both:.4f} ms; its ys vs the forward kernel max |d| "
          f"{lib_diff:.2e}; the port's layer (both kernels and the matmuls "
          f"around them) forward + backward {port_both:.4f} ms", flush=True)
    timings = {}
    for kind, (kernel, plain) in fns.items():
        p1 = time_ms(torch, plain, 10)
        k1 = time_ms(torch, kernel, 100)
        k2 = time_ms(torch, kernel, 100)
        p2 = time_ms(torch, plain, 10)
        bound_ms, bound_by = lstm_bound(B, T, H, kind)
        prof = device_profile(torch, lambda: [kernel() for _ in range(20)])
        dev_ms = None
        if prof is not None:
            keys = [k for k in prof[2] if f"lstm_{kind}_kernel" in k]
            n = sum(prof[3][k] for k in keys)
            if n:
                dev_ms = sum(prof[2][k] for k in keys) / n
        timings[kind] = dict(kernel_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                             bound_ms=bound_ms, bound_by=bound_by,
                             device_ms=dev_ms,
                             library_ms=lib_fwd if kind == "fwd" else lib_bwd,
                             max_err=errs[kind])
        print(f"  lstm_{kind} config1: kernel_ms {timings[kind]['kernel_ms']:.4f}"
              f" ({k1:.4f}, {k2:.4f}; "
              f"{1e3 * timings[kind]['kernel_ms'] / T:.2f} us a step), "
              f"device_ms "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'}, "
              f"plain_ms {timings[kind]['plain_ms']:.4f} ({p1:.4f}, {p2:.4f}),"
              f" library_ms {timings[kind]['library_ms']:.4f} "
              f"({1e3 * timings[kind]['library_ms'] / T:.2f} us a step), "
              f"bound_ms {bound_ms:.6f} ({bound_by}); the T={T} dependent "
              "steps are a latency floor the bound does not see", flush=True)
    return timings


def train_phase(torch, cli, cl, device):
    print("== phase 6: train config 1 through the CLI", flush=True)
    from lstm_tensorspark_torch.data import get_dataset, lm_windows

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")

    def run(name, extra):
        path = os.path.join(tmp, f"{name}.jsonl")
        rc = cli.main(TRAIN_FLAGS + extra + ["--jsonl", path])
        if rc != 0:
            fail(f"train run {name} exited {rc}")
        with open(path) as f:
            return [json.loads(line) for line in f]

    # the first steps on the card against the CPU's plain versions: 10 at
    # config 1, and 5 of a 2-layer stack (each layer through the kernels)
    first = {}
    for layers, n in ((1, 10), (2, 5)):
        for dev in ("cuda", "cpu"):
            cl.fwd_counts.reset()
            cl.bwd_counts.reset()
            recs = run(f"first{n}_L{layers}_{dev}",
                       ["--num-steps", str(n), "--log-every", "1",
                        "--num-layers", str(layers), "--device", dev])
            first[layers, dev] = [r["loss"] for r in recs if "loss" in r]
            if len(first[layers, dev]) != n:
                fail(f"the {dev} run logged {len(first[layers, dev])} "
                     f"losses, not {n}")
            if dev == "cuda" and cl.bwd_counts.kernel != n * layers:
                fail(f"{layers}-layer card run: {cl.bwd_counts.kernel} "
                     f"backward launches, not {n * layers}")
        a, b = first[layers, "cuda"], first[layers, "cpu"]
        gap = max(abs(x - y) for x, y in zip(a, b))
        print(f"  L={layers}, first {n} losses: card "
              f"{[round(x, 6) for x in a]}; CPU {[round(x, 6) for x in b]}; "
              f"max |d| {gap:.2e}", flush=True)
        if not gap <= TRAIN_LOSS_TOL:
            fail(f"{layers}-layer card losses differ from the CPU run by "
                 f"{gap:.3e} > {TRAIN_LOSS_TOL}")
    first_loss = first[1, "cuda"][0]

    # the main run: every LSTM layer forward and backward through the kernels
    data = get_dataset("ptb_char")
    valid = data["valid"]
    eval_bs = min(64, (len(valid) - 1) // 64)
    per_eval = min(EVAL_BATCHES, lm_windows(valid, eval_bs, 64)[2])
    n_evals = TRAIN_STEPS // EVAL_EVERY + 1  # the cadence, then the final
    layers = 1
    cl.fwd_counts.reset()
    cl.bwd_counts.reset()
    recs = run("main", ["--num-steps", str(TRAIN_STEPS), "--log-every", "50",
                        "--eval-every", str(EVAL_EVERY), "--eval-batches",
                        str(EVAL_BATCHES), "--device", "cuda"])
    launches = {"fwd": cl.fwd_counts.kernel, "bwd": cl.bwd_counts.kernel}
    plain = cl.fwd_counts.reference + cl.bwd_counts.reference
    expect = {"fwd": TRAIN_STEPS * layers + n_evals * per_eval * layers,
              "bwd": TRAIN_STEPS * layers}
    print(f"  kernel launches {launches} (expected {expect}: {TRAIN_STEPS} "
          f"steps x {layers} layer, + {n_evals} evals x {per_eval} batches "
          f"forward); plain runs {plain}", flush=True)
    if launches != expect or plain != 0:
        fail(f"launch counts {launches} (plain {plain}) != {expect}")
    for r in recs:
        print(f"  {json.dumps(r)}", flush=True)
    logged = [r for r in recs if "loss" in r]
    final = recs[-1]
    if final.get("note") != "final" or not final.get("eval_ppl", 0) > 0:
        fail(f"the run did not end with a final eval record: {final}")
    if not logged[-1]["loss"] < first_loss:
        fail(f"the loss did not fall: {first_loss} -> {logged[-1]['loss']}")
    steady = sorted(r["steps_per_sec"] for r in logged[1:])
    tps = sorted(r["tokens_per_sec"] for r in logged[1:])
    sps, tok = steady[len(steady) // 2], tps[len(tps) // 2]
    print(f"  loss at step 1 {first_loss:.6f}, at step "
          f"{logged[-1]['step']} {logged[-1]['loss']:.6f}; final eval_loss "
          f"{final['eval_loss']:.6f}, eval_ppl {final['eval_ppl']:.4f}; "
          f"steady state (median of the log windows after the first) "
          f"{sps:.1f} steps/s, {tok:.1f} tokens/s", flush=True)

    # device idle share over 20 steps under torch.profiler, through the same
    # library calls the CLI makes
    from lstm_tensorspark_torch.data import lm_batch_stream
    from lstm_tensorspark_torch.models import lstm_lm as tlm
    from lstm_tensorspark_torch.train import (init_train_state, make_optimizer,
                                              make_train_step)
    from lstm_tensorspark_torch.train.loop import device_batches

    cfg = tlm.LMConfig(vocab_size=len(data["vocab"]), hidden_size=128)
    params = tlm.params_to(tlm.init_lm(torch.Generator().manual_seed(0), cfg),
                           device)
    opt = make_optimizer("sgd", 0.5)
    state = init_train_state(params, opt,
                             carries=tlm.init_carries(cfg, 64, device=device))
    step = make_train_step(
        lambda p, b, c=None: tlm.lm_loss(p, b, cfg, carries=c), opt,
        stateful=True)
    batches = device_batches(lm_batch_stream(data["train"], 64, 64), device)
    for _ in range(5):
        state, m = step(state, next(batches))
    holder = [state]

    def twenty():
        s = holder[0]
        for _ in range(20):
            s, m = step(s, next(batches))
        holder[0] = s
        return m

    prof = device_profile(torch, twenty)
    idle = None
    if prof is None:
        print("  20 steps under torch.profiler: no device time recorded "
              "(idle share not measured)", flush=True)
    else:
        busy, wall, by_name, _ = prof
        idle = 1 - busy / wall
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"  20 steps under torch.profiler: device busy {busy:.3f} ms "
              f"of {wall:.3f} ms wall (idle share {idle:.3f}); top: "
              + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top), flush=True)
    return launches


def imdb_lengths(B, T):
    """The lengths of the IMDB stand-in's first config-2 training batch
    (shuffle seed 0, length buckets): what the kernels' mask sees."""
    from lstm_tensorspark_torch.data import get_dataset, padded_batches

    seqs, labels = get_dataset("imdb", max_len=T)["train"]
    return next(padded_batches(seqs, labels, B, T, shuffle_seed=0))["lengths"]


def lstmx_inputs(torch, B, T, D, H, ndir, lengths, seed, device):
    """Seeded direction-stacked inputs of the residentx pair — xs, W, b, U,
    h0, c0, mask (or None) — and the backward's cotangents dys, dhT, dcT,
    on ``device``. With ``lengths`` each direction's rows are right-padded
    to them; the second direction's mask is time-flipped, as the bi-LSTM
    layer feeds it."""
    g = torch.Generator().manual_seed(seed)
    BS, G = ndir * B, 4 * H
    xs = torch.randn(T, BS, D, generator=g)
    W = torch.randn(ndir, D, G, generator=g) / D ** 0.5
    b = torch.randn(ndir, G, generator=g) * 0.1
    U = torch.randn(ndir, H, G, generator=g) / H ** 0.5
    h0 = torch.randn(BS, H, generator=g) * 0.5
    c0 = torch.randn(BS, H, generator=g) * 0.5
    mask = None
    if lengths is not None:
        m = (torch.arange(T)[:, None]
             < torch.as_tensor(lengths)[None, :]).float()
        mask = m if ndir == 1 else torch.cat([m, torch.flip(m, dims=(0,))], 1)
    dys = torch.randn(T, BS, H, generator=g)
    dhT = torch.randn(BS, H, generator=g)
    dcT = torch.randn(BS, H, generator=g)

    def dev(t):
        return None if t is None else t.to(device).contiguous()

    return ([dev(t) for t in (xs, W, b, U, h0, c0, mask)],
            [dev(t) for t in (dys, dhT, dcT)])


def lstmx_bound(B, T, D, H, ndir, kind, masked, save_c=True):
    """Least time of one call of the pair: the larger of the bytes it must
    move (each input read once, each output written once) over HBM
    bandwidth and its products' FLOPs over the float32 peak. The forward
    (with ``save_c``: its cs writes) does the projection and h @ U,
    2·T·BS·(D+H)·4H; the backward rebuilds z (the same) and does dz @ Uᵀ,
    2·T·BS·4H·H."""
    BS, G = ndir * B, 4 * H
    weights = ndir * (D * G + G + H * G)
    if kind == "fwd":  # xs, W, b, U, h0, c0 in; ys, hT, cT (and cs) out
        floats = T * BS * D + weights + 2 * BS * H + T * BS * H \
            + 2 * BS * H + (T * BS * H if save_c else 0)
        flops = 2 * T * BS * (D + H) * G
    else:  # xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT in; dz, dh0, dc0 out
        floats = T * BS * D + 3 * T * BS * H + 4 * BS * H + weights \
            + T * BS * G + 2 * BS * H
        flops = 2 * T * BS * (D + H) * G + 2 * T * BS * G * H
    nbytes = 4 * (floats + (T * BS if masked else 0))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def cudnn_bi_yardstick(torch, B, T, D, H, ndir, device):
    """cuDNN's ``torch.nn.LSTM`` (bidirectional when ``ndir`` is 2) on one
    layer at the same B, T, D, H, unmasked, TF32 off: (forward ms, backward
    alone ms). It does more than the kernels — its forward includes the
    input product for both directions' inputs, its backward also gives dx,
    dW, dU and db — so it is a yardstick, not a like-for-like time; the
    port never calls it."""
    lstm = torch.nn.LSTM(D, H, bidirectional=ndir == 2).to(device)
    g = torch.Generator().manual_seed(11)
    x = torch.randn(T, B, D, generator=g).to(device).requires_grad_()
    dy = torch.randn(T, B, ndir * H, generator=g).to(device)
    ys, _ = lstm(x)

    def fwd():
        return lstm(x)

    def bwd():
        return torch.autograd.grad(ys, [x, *lstm.parameters()], dy,
                                   retain_graph=True)

    return time_ms(torch, fwd, 20), time_ms(torch, bwd, 20)


# Each role is timed at the shape of the run its launches on the main path
# come from (phase 8): the one-direction forward as config 2 runs it under
# --remat-chunk 50 (inside the recompute Function, so without cs), the
# one-direction backward in the LM at --seq-len 256, the stacked pair in
# config 2's main run (the forward of a training step, with cs).
LSTMX_ROLES = {  # role: (shape, ndir, kind, masked, save_c)
    "lstmx_fwd": ("config2", 1, "fwd", True, False),
    "lstmx_bwd": ("lm256", 1, "bwd", False, True),
    "bilstm_fwd": ("config2", 2, "fwd", True, True),
    "bilstm_bwd": ("config2", 2, "bwd", True, True),
}


def lstmx_kernel_phase(torch, cx, device):
    print("== phase 7: residentx kernels (one and two directions) vs plain "
          "versions", flush=True)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    B2, T2, D2, H2 = (CONFIG2[k] for k in ("B", "T", "D", "H"))
    lens2 = imdb_lengths(B2, T2)
    print(f"  IMDB stand-in lengths of the first config-2 batch: min "
          f"{int(lens2.min())}, max {int(lens2.max())}, mean "
          f"{float(lens2.mean()):.1f}", flush=True)
    shapes = {"config2": CONFIG2, "lm256": LM256, "awkward": AWKWARD}
    aw = AWKWARD
    lens_aw = [aw["T"] - 3 * i for i in range(aw["B"])]
    lens_aw[-1] = 1
    cases = []
    for ndir in (1, 2):
        cases += [("config2", ndir, lens2), ("config2", ndir, None)]
        if ndir == 1:
            cases.append(("lm256", 1, None))
        cases.append(("awkward", ndir, lens_aw))
    errs = {("fwd", 1): 0.0, ("bwd", 1): 0.0, ("fwd", 2): 0.0, ("bwd", 2): 0.0}
    for i, (name, ndir, lens) in enumerate(cases):
        B, T, D, H = (shapes[name][k] for k in ("B", "T", "D", "H"))
        label = (f"{name} B={B} T={T} D={D} H={H} ndir={ndir} "
                 f"mask={lens is not None}")
        inputs, (dys, dhT, dcT) = lstmx_inputs(torch, B, T, D, H, ndir, lens,
                                               seed=20 + i, device=device)
        xs, W, b, U, h0, c0, mask = inputs
        got = cx.lstmx_forward(*inputs, save_c=True)
        bare = cx.lstmx_forward(*inputs)
        ref = cx.lstmx_forward_reference(*inputs, save_c=True)
        torch.cuda.synchronize()
        e = {}
        for n, a, r in zip(("ys", "hT", "cT", "cs"), got, ref):
            e[n] = held(torch, n, a, r, label, scaled=False)
        for n, a, r in zip(("ys", "hT", "cT"), bare, got):
            if not torch.equal(a, r):
                fail(f"{label}: the forward without cs gives other {n} than "
                     "with it")
        ys, cs = ref[0], ref[3]
        bgot = cx.lstmx_backward(xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT,
                                 mask)
        bref = cx.lstmx_backward_reference(xs, ys, h0, cs, c0, dys, W, b, U,
                                           dhT, dcT, mask)
        torch.cuda.synchronize()
        for n, a, r in zip(("dz", "dh0", "dc0"), bgot, bref):
            e[n] = held(torch, n, a, r, label, scaled=True)
        errs["fwd", ndir] = max(errs["fwd", ndir],
                                *(e[n] for n in ("ys", "hT", "cT", "cs")))
        errs["bwd", ndir] = max(errs["bwd", ndir], e["dz"], e["dh0"],
                                e["dc0"])
        print(f"  {label}: max |d| " + ", ".join(
            f"{n} {v:.2e}" for n, v in e.items()), flush=True)
        print(f"    plan {cx.card_plan(B, H, D, ndir, device)}", flush=True)

    timings = {}
    lib = {}
    for role, (name, nd, kind, masked, save_c) in LSTMX_ROLES.items():
        B, T, D, H = (shapes[name][k] for k in ("B", "T", "D", "H"))
        if (name, nd) not in lib:
            lib[name, nd] = cudnn_bi_yardstick(torch, B, T, D, H, nd, device)
            print(f"  cuDNN torch.nn.LSTM{' bidirectional' if nd == 2 else ''}"
                  f" (yardstick; also the input product, dx and the weight "
                  f"gradients) {name} B={B} T={T} D={D} H={H}: forward "
                  f"{lib[name, nd][0]:.4f} ms, backward alone "
                  f"{lib[name, nd][1]:.4f} ms", flush=True)
        inputs, (dys, dhT, dcT) = lstmx_inputs(
            torch, B, T, D, H, nd, lens2 if masked else None, seed=7,
            device=device)
        xs, W, b, U, h0, c0, mask = inputs
        ys, _, _, cs = cx.lstmx_forward(*inputs, save_c=True)
        bargs = (xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask)
        if kind == "fwd":
            def kernel():
                return cx.lstmx_forward(*inputs, save_c=save_c)

            def plain():
                return cx.lstmx_forward_reference(*inputs, save_c=save_c)
        else:
            def kernel():
                return cx.lstmx_backward(*bargs)

            def plain():
                return cx.lstmx_backward_reference(*bargs)
        p1 = time_ms(torch, plain, 2)
        k1 = time_ms(torch, kernel, 10)
        k2 = time_ms(torch, kernel, 10)
        p2 = time_ms(torch, plain, 2)
        bound_ms, bound_by = lstmx_bound(B, T, D, H, nd, kind, masked, save_c)
        prof = device_profile(torch, lambda: [kernel() for _ in range(10)])
        dev_ms = rebuild_ms = None
        if prof is not None:
            keys = [k for k in prof[2] if f"lstmx_{kind}_kernel" in k]
            n = sum(prof[3][k] for k in keys)
            if n:
                dev_ms = sum(prof[2][k] for k in keys) / n
            keys = [k for k in prof[2] if "lstmx_factors_kernel" in k]
            n = sum(prof[3][k] for k in keys)
            if n:
                rebuild_ms = sum(prof[2][k] for k in keys) / n
        timings[role] = dict(
            kernel_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
            bound_ms=bound_ms, bound_by=bound_by, device_ms=dev_ms,
            library_ms=lib[name, nd][0 if kind == "fwd" else 1],
            max_err=errs[kind, nd])
        both = "" if kind == "fwd" else (
            " (the chain; its z rebuild beside it "
            + ("not measured" if rebuild_ms is None else f"{rebuild_ms:.4f}")
            + ")")
        print(f"  {role} {name} B={B} T={T} D={D} H={H} (mask={masked}, "
              f"cs={save_c if kind == 'fwd' else 'in'}): kernel_ms "
              f"{timings[role]['kernel_ms']:.4f} ({k1:.4f}, {k2:.4f}; "
              f"{1e3 * timings[role]['kernel_ms'] / T:.2f} us a step), "
              f"device_ms "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'}"
              f"{both}, plain_ms {timings[role]['plain_ms']:.4f} ({p1:.4f}, "
              f"{p2:.4f}), library_ms {timings[role]['library_ms']:.4f} "
              f"({1e3 * timings[role]['library_ms'] / T:.2f} us a step), "
              f"bound_ms {bound_ms:.6f} ({bound_by})", flush=True)
    rows_ab(torch, cx, lens2, sms, device)
    return timings


def rows_ab(torch, cx, lens2, sms, device):
    """The stacked pair at config 2 under the card's plan and under the
    other row cut of each kernel, alternated with CUDA events: the forward
    with 4-row clusters (16 of them, more than the card keeps at once: the
    plan for every cluster resident), and the same for the backward (its
    card plan takes 8-row clusters, one wave).
    The forward's results must not change by a bit (none of its sums
    depends on the rows); the backward's dz @ Uᵀ split follows its rows,
    so under either cut its dz, dh0, dc0 are held against the plain
    version with the phase's tolerance."""
    B2, T2, D2, H2 = (CONFIG2[k] for k in ("B", "T", "D", "H"))
    inputs, (dys, dhT, dcT) = lstmx_inputs(torch, B2, T2, D2, H2, 2, lens2,
                                           seed=7, device=device)
    xs, W, b, U, h0, c0, mask = inputs
    card = cx.card_plan(B2, H2, D2, 2, device)
    alt = {kind: card._replace(**{kind: getattr(cx.plan(B2, H2, D2, 2, sms),
                                                kind)})
           for kind in ("fwd", "bwd")}
    ys, _, _, cs = cx.lstmx_forward(*inputs, save_c=True)
    bargs = (xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask)
    calls = {"fwd": lambda p: cx.lstmx_forward(*inputs, save_c=True, xplan=p),
             "bwd": lambda p: cx.lstmx_backward(*bargs, xplan=p)}
    bref = cx.lstmx_backward_reference(*bargs)
    parts, bwd_err = [], 0.0
    for kind in ("fwd", "bwd"):
        a, o = getattr(card, kind), getattr(alt[kind], kind)
        got, other = calls[kind](card), calls[kind](alt[kind])
        if kind == "fwd":
            if not all(torch.equal(x, y) for x, y in zip(got, other)):
                fail("bilstm_fwd: the row cut changed the results")
        else:
            for p, out in (("card plan", got), ("other cut", other)):
                for n, x, r in zip(("dz", "dh0", "dc0"), out, bref):
                    bwd_err = max(bwd_err, held(
                        torch, n, x, r, f"bilstm_bwd row cut ({p})", True))
        t = {p: [] for p in ("card", "alt")}
        for p in ("card", "alt", "alt", "card"):
            pl = card if p == "card" else alt[kind]
            t[p].append(time_ms(torch, lambda: calls[kind](pl), 10))
        parts.append(
            f"{kind} card plan {a.rows} rows ({a.groups * 2} clusters, chunk "
            f"{a.chunk}) {sum(t['card']) / 2:.4f} ms ({t['card'][0]:.4f}, "
            f"{t['card'][1]:.4f}) vs {o.rows} rows ({o.groups * 2} clusters, "
            f"chunk {o.chunk}) {sum(t['alt']) / 2:.4f} ms ({t['alt'][0]:.4f}, "
            f"{t['alt'][1]:.4f})")
    print(f"  row cut of the stacked pair at config 2 (the card keeps "
          f"{cx.max_clusters(device, card.cluster)} clusters of "
          f"{card.cluster}; forward results bit-equal, backward within "
          f"{bwd_err:.2e} of the plain version): " + "; ".join(parts),
          flush=True)


def config2_phase(torch, cli, cl, cx, ct, device):
    print("== phase 8: train config 2 through the CLI", flush=True)
    from lstm_tensorspark_torch.data import get_dataset

    tmp = tempfile.mkdtemp(prefix="chip_smoke_config2_")
    counters = all_counters(cl, cx, ct)

    def run(name, flags):
        """One CLI run with every count set to 0 just before it; returns
        its records and the kernel launches it made (plain runs under
        'plain')."""
        for c in counters.values():
            c.reset()
        path = os.path.join(tmp, f"{name}.jsonl")
        rc = cli.main(flags + ["--jsonl", path])
        if rc != 0:
            fail(f"train run {name} exited {rc}")
        launches = {k: c.kernel for k, c in counters.items()}
        launches["plain"] = sum(c.reference for c in counters.values())
        with open(path) as f:
            return [json.loads(line) for line in f], launches

    def expect(got, name, **want):
        full = {k: 0 for k in counters}
        full.update(want)
        full["plain"] = 0
        if got != full:
            fail(f"{name}: launch counts {got} != predicted {full}")

    # the CPU reference runs once, without remat: with --remat-chunk the
    # plain scan gives the same values (tests/test_torch_scan_routes.py), so
    # both card runs are held against it
    first = {}
    for remat, devs in ((None, ("cuda", "cpu")), (50, ("cuda",))):
        extra = [] if remat is None else ["--remat-chunk", str(remat)]
        for dev in devs:
            name = f"first10_remat{remat}_{dev}"
            t0 = time.perf_counter()
            recs, launches = run(name, CONFIG2_FLAGS + extra + [
                "--num-steps", "10", "--log-every", "1", "--dropout", "0",
                "--eval-batches", "1", "--device", dev])
            first[remat, dev] = [r["loss"] for r in recs if "loss" in r]
            if len(first[remat, dev]) != 10:
                fail(f"{name} logged {len(first[remat, dev])} losses, not 10")
            if dev == "cuda":
                # 10 steps and one eval batch; with remat each direction is
                # its own scan and the backward is the plain recompute
                if remat is None:
                    expect(launches, name, bilstm_fwd=11, bilstm_bwd=10)
                else:
                    expect(launches, name, lstmx_fwd=22)
                    remat_launches = launches
            print(f"  {name}: {time.perf_counter() - t0:.1f} s, launches "
                  f"{launches}", flush=True)
        a, b = first[remat, "cuda"], first[None, "cpu"]
        gap = max(abs(x - y) for x, y in zip(a, b))
        print(f"  remat_chunk={remat}, first 10 losses: card "
              f"{[round(x, 6) for x in a]}; CPU {[round(x, 6) for x in b]}; "
              f"max |d| {gap:.2e}", flush=True)
        if not gap <= TRAIN_LOSS_TOL:
            fail(f"config 2 (remat_chunk={remat}) card losses differ from "
                 f"the CPU run by {gap:.3e} > {TRAIN_LOSS_TOL}")

    # the main run: every bi-layer forward and backward through the stacked
    # kernels, dropout on
    valid = get_dataset("imdb", max_len=CONFIG2["T"])["valid"][0]
    per_eval = -(-len(valid) // CONFIG2["B"])  # filler rows pad the last
    n_evals = CONFIG2_STEPS // CONFIG2_EVAL_EVERY + 1
    recs, launches = run("main", CONFIG2_FLAGS + [
        "--num-steps", str(CONFIG2_STEPS), "--log-every", "50",
        "--eval-every", str(CONFIG2_EVAL_EVERY), "--dropout", "0.2",
        "--device", "cuda"])
    want = dict(bilstm_fwd=CONFIG2_STEPS + n_evals * per_eval,
                bilstm_bwd=CONFIG2_STEPS)
    print(f"  kernel launches {launches} (predicted {want}: {CONFIG2_STEPS} "
          f"steps, + {n_evals} evals x {per_eval} batches forward)",
          flush=True)
    expect(launches, "main", **want)
    main_launches = launches
    for r in recs:
        print(f"  {json.dumps(r)}", flush=True)
    logged = [r for r in recs if "loss" in r]
    final = recs[-1]
    if final.get("note") != "final" or not 0.0 <= final.get(
            "eval_accuracy", -1.0) <= 1.0:
        fail(f"the run did not end with a final eval record: {final}")
    if not all(r["loss"] == r["loss"] and r["loss"] < 1e9 for r in logged):
        fail("a logged loss is not finite")
    sps = sorted(r["steps_per_sec"] for r in logged[1:])
    eps = sorted(r["examples_per_sec"] for r in logged[1:])
    print(f"  loss at step 1 {first[None, 'cuda'][0]:.6f} (dropout 0 run), "
          f"at step {logged[0]['step']} {logged[0]['loss']:.6f}, at step "
          f"{logged[-1]['step']} {logged[-1]['loss']:.6f}; final eval_loss "
          f"{final['eval_loss']:.6f}, eval_accuracy "
          f"{final['eval_accuracy']:.4f}; steady state (median of the log "
          f"windows after the first) {sps[len(sps) // 2]:.2f} steps/s, "
          f"{eps[len(eps) // 2]:.1f} examples/s", flush=True)

    # the LM at T=256: the single-direction residentx pair
    lm = {}
    for dev in ("cuda", "cpu"):
        recs, launches = run(f"lm256_{dev}", TRAIN_FLAGS + [
            "--seq-len", "256", "--num-steps", "10", "--log-every", "1",
            "--eval-batches", "1", "--device", dev])
        lm[dev] = [r["loss"] for r in recs if "loss" in r]
        if dev == "cuda":
            expect(launches, "lm256_cuda", lstmx_fwd=11, lstmx_bwd=10)
            lm_launches = launches
    gap = max(abs(x - y) for x, y in zip(lm["cuda"], lm["cpu"]))
    print(f"  LM at --seq-len 256, first 10 losses: card "
          f"{[round(x, 6) for x in lm['cuda']]}; CPU "
          f"{[round(x, 6) for x in lm['cpu']]}; max |d| {gap:.2e}; launches "
          f"{lm_launches}", flush=True)
    if len(lm["cuda"]) != 10 or not gap <= TRAIN_LOSS_TOL:
        fail(f"LM at T=256: card losses differ from the CPU run by {gap:.3e}")

    # device idle share over 20 config-2 steps under torch.profiler, through
    # the same library calls the CLI makes
    from lstm_tensorspark_torch.data import epoch_stream, padded_batches
    from lstm_tensorspark_torch.models import classifier as tclf
    from lstm_tensorspark_torch.train import (init_train_state, make_optimizer,
                                              make_train_step)
    from lstm_tensorspark_torch.train.loop import device_batches

    data = get_dataset("imdb", max_len=CONFIG2["T"])
    cfg = tclf.ClassifierConfig(vocab_size=len(data["vocab"]),
                                hidden_size=CONFIG2["H"], dropout=0.2)
    params = tclf.classifier_params_to(
        tclf.init_classifier(torch.Generator().manual_seed(0), cfg), device)
    gen = torch.Generator(device=device).manual_seed(1)
    opt = make_optimizer("adam", 1e-3, clip_norm=1.0)
    state = init_train_state(params, opt)
    step = make_train_step(
        lambda p, b: tclf.classifier_loss(p, b, cfg, dropout_gen=gen), opt)
    batches = device_batches(epoch_stream(
        lambda e: padded_batches(*data["train"], CONFIG2["B"], CONFIG2["T"],
                                 shuffle_seed=e), steps_per_epoch=50), device)
    for _ in range(5):
        state, m = step(state, next(batches))
    holder = [state]

    def twenty():
        s = holder[0]
        for _ in range(20):
            s, m = step(s, next(batches))
        holder[0] = s
        return m

    prof = device_profile(torch, twenty)
    if prof is None:
        print("  20 steps under torch.profiler: no device time recorded "
              "(idle share not measured)", flush=True)
    else:
        busy, wall, by_name, _ = prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"  20 config-2 steps under torch.profiler: device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall (idle share "
              f"{1 - busy / wall:.3f}); top: "
              + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top), flush=True)
    return {"lstmx_fwd": remat_launches["lstmx_fwd"],
            "lstmx_bwd": lm_launches["lstmx_bwd"],
            "bilstm_fwd": main_launches["bilstm_fwd"],
            "bilstm_bwd": main_launches["bilstm_bwd"]}


def all_counters(cl, cx, ct):
    """Every recurrence kernel's launch counter, by kernel name."""
    return {"lstm_fwd": cl.fwd_counts, "lstm_bwd": cl.bwd_counts,
            "lstmx_fwd": cx.fwdx_counts, "lstmx_bwd": cx.bwdx_counts,
            "bilstm_fwd": cx.bi_fwdx_counts, "bilstm_bwd": cx.bi_bwdx_counts,
            "lstm_tiled_fwd": ct.fwd_counts, "lstm_tiled_bwd": ct.bwd_counts}


def in_turns(torch, first, second, iters):
    """(first ms, second ms), each the mean of two CUDA-event timings taken
    in turns (first, second, second, first), and the four readings."""
    a1 = time_ms(torch, first, iters)
    b1 = time_ms(torch, second, iters)
    b2 = time_ms(torch, second, iters)
    a2 = time_ms(torch, first, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2, (a1, b1, b2, a2)


def profiled_ms(torch, fn, name, calls):
    """Device ms per launch of kernel ``name`` under ``torch.profiler`` over
    ``calls`` calls of ``fn``, or None when the profiler records none."""
    prof = device_profile(torch, lambda: [fn() for _ in range(calls)])
    if prof is None:
        return None
    keys = [k for k in prof[2] if name in k]
    n = sum(prof[3][k] for k in keys)
    return sum(prof[2][k] for k in keys) / n if n else None


def tiled_kernel_phase(torch, cl, ct, device):
    print("== phase 9: tiled LSTM kernels vs plain versions", flush=True)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    errs = {"fwd": 0.0, "bwd": 0.0}
    for name, spec in (("config5", LSTM_CONFIG5), ("config5-b64", LSTM_B64),
                       ("config3", LSTM_CONFIG3)):
        B, T, H = spec["B"], spec["T"], spec["H"]
        for masked in (False, True):
            label = f"{name} B={B} T={T} H={H} mask={masked}"
            inputs, (dys, dhT, dcT) = lstm_inputs(torch, B, T, H, masked,
                                                  seed=B + H + masked,
                                                  device=device)
            got = ct.lstm_tiled_forward(*inputs, save_residuals=True)
            bare = ct.lstm_tiled_forward(*inputs)
            ref = cl.lstm_forward_reference(*inputs, save_residuals=True)
            torch.cuda.synchronize()
            e = {}
            for n, a, r in zip(("ys", "hT", "cT", "z", "cs"), got, ref):
                e[n] = held(torch, n, a, r, label, scaled=n == "z")
            for n, a, r in zip(("ys", "hT", "cT"), bare, got):
                if not torch.equal(a, r):
                    fail(f"{label}: the tiled forward without residuals "
                         f"gives other {n} than with them")
            ys, hT, cT, z, cs = ref
            c_prev = torch.cat([inputs[3][None], cs[:-1]])
            bgot = ct.lstm_tiled_backward(z, inputs[3], cs, dys, inputs[1],
                                          dhT, dcT, inputs[4])
            bref = cl.lstm_backward_reference(z, c_prev, dys, inputs[1], dhT,
                                              dcT, inputs[4])
            torch.cuda.synchronize()
            for n, a, r in zip(("dz", "dh0", "dc0"), bgot, bref):
                e[n] = held(torch, n, a, r, label, scaled=True)
            errs["fwd"] = max(errs["fwd"], *(e[n] for n in
                                             ("ys", "hT", "cT", "z", "cs")))
            errs["bwd"] = max(errs["bwd"], e["dz"], e["dh0"], e["dc0"])
            print(f"  {label}: max |d| " + ", ".join(
                f"{n} {v:.2e}" for n, v in e.items()), flush=True)
        for kind in ("fwd", "bwd"):
            p = ct.plan(kind, B, H, sms)
            print(f"  {name} tiled {kind} plan: {p.blocks} blocks of "
                  f"{ct.THREADS} threads, {p.units} units a block, h tile "
                  f"{p.ktile} rows, split {p.ksplit}, {p.smem_bytes} bytes of "
                  "shared memory a block", flush=True)

    # timing at config 5's shard, the training path's shapes (forward with
    # residuals, unmasked)
    B, T, H = LSTM_CONFIG5["B"], LSTM_CONFIG5["T"], LSTM_CONFIG5["H"]
    inputs, (dys, dhT, dcT) = lstm_inputs(torch, B, T, H, False, seed=1,
                                          device=device)
    _, _, _, z, cs = ct.lstm_tiled_forward(*inputs, save_residuals=True)
    c_prev = torch.cat([inputs[3][None], cs[:-1]])
    bargs = (z, inputs[3], cs, dys, inputs[1], dhT, dcT)
    fns = {
        "fwd": (lambda: ct.lstm_tiled_forward(*inputs, save_residuals=True),
                lambda: cl.lstm_forward_reference(*inputs,
                                                  save_residuals=True)),
        "bwd": (lambda: ct.lstm_tiled_backward(*bargs),
                lambda: cl.lstm_backward_reference(
                    z, c_prev, dys, inputs[1], dhT, dcT)),
    }
    lib_fwd, lib_bwd, lib_both, lib_diff, port_both = cudnn_yardstick(
        torch, ct.lstm_tiled_forward, ct.cuda_lstm_tiled_scan, inputs,
        (dys, dhT, dcT))
    print(f"  cuDNN torch.nn.LSTM (yardstick, input width {H}) at config "
          f"5's shard B={B} T={T} H={H}: forward {lib_fwd:.4f} ms, backward "
          f"alone {lib_bwd:.4f} ms, forward + backward {lib_both:.4f} ms; its"
          f" ys vs the tiled forward max |d| {lib_diff:.2e}; the port's layer"
          f" (both tiled kernels and the matmuls around them) forward + "
          f"backward {port_both:.4f} ms", flush=True)
    timings = {}
    for kind, (kernel, plain) in fns.items():
        plain_ms, kernel_ms, r = in_turns(torch, plain, kernel, 5)
        bound_ms, bound_by = lstm_bound(B, T, H, kind)
        dev_ms = profiled_ms(torch, kernel, f"lstm_tiled_{kind}_kernel", 20)
        timings[kind] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             device_ms=dev_ms,
                             library_ms=lib_fwd if kind == "fwd" else lib_bwd,
                             max_err=errs[kind])
        print(f"  lstm_tiled_{kind} config5: kernel_ms {kernel_ms:.4f} "
              f"({r[1]:.4f}, {r[2]:.4f}), device_ms "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'}, "
              f"plain_ms {plain_ms:.4f} ({r[0]:.4f}, {r[3]:.4f}), library_ms "
              f"{timings[kind]['library_ms']:.4f}, bound_ms {bound_ms:.6f} "
              f"({bound_by}); the T={T} dependent steps and grid barriers "
              "are a latency floor the bound does not see", flush=True)

    # the route at config 3's width: the tiled pair against the resident
    # pair (U read through L2 there), in turns
    B, T, H = LSTM_CONFIG3["B"], LSTM_CONFIG3["T"], LSTM_CONFIG3["H"]
    inputs, (dys, dhT, dcT) = lstm_inputs(torch, B, T, H, False, seed=3,
                                          device=device)
    _, _, _, z, cs = ct.lstm_tiled_forward(*inputs, save_residuals=True)
    bargs = (z, inputs[3], cs, dys, inputs[1], dhT, dcT)
    parts = []
    for kind, res, til in (
            ("fwd", lambda: cl.lstm_forward(*inputs, save_residuals=True),
             lambda: ct.lstm_tiled_forward(*inputs, save_residuals=True)),
            ("bwd", lambda: cl.lstm_backward(*bargs),
             lambda: ct.lstm_tiled_backward(*bargs))):
        res_ms, til_ms, r = in_turns(torch, res, til, 10)
        parts.append(f"{kind} resident {res_ms:.4f} ms ({r[0]:.4f}, "
                     f"{r[3]:.4f}) vs tiled {til_ms:.4f} ms ({r[1]:.4f}, "
                     f"{r[2]:.4f})")
    print(f"  route at config 3's width B={B} T={T} H={H} (resident plan "
          f"keeps U in shared memory: {cl.plan('fwd', B, H, sms).smem_w}): "
          + "; ".join(parts), flush=True)
    return timings


def config5_phase(torch, cli, cl, cx, ct, device):
    print("== phase 10: train config 5's model through the CLI", flush=True)
    from lstm_tensorspark_torch.data import get_dataset, lm_windows

    tmp = tempfile.mkdtemp(prefix="chip_smoke_config5_")
    counters = all_counters(cl, cx, ct)

    def run(name, flags):
        """One CLI run with every count set to 0 just before it; returns
        its records and the kernel launches it made (plain runs under
        'plain')."""
        for c in counters.values():
            c.reset()
        path = os.path.join(tmp, f"{name}.jsonl")
        t0 = time.perf_counter()
        rc = cli.main(flags + ["--jsonl", path])
        if rc != 0:
            fail(f"train run {name} exited {rc}")
        launches = {k: c.kernel for k, c in counters.items()}
        launches["plain"] = sum(c.reference for c in counters.values())
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return recs, launches

    def expect(got, name, **want):
        full = {k: 0 for k in counters}
        full.update(want)
        full["plain"] = 0
        if got != full:
            fail(f"{name}: launch counts {got} != predicted {full}")

    L, n = CONFIG5["L"], CONFIG5_FIRST
    # the CPU reference runs once, without remat: with --remat-chunk the
    # plain scan gives the same values, so both card runs are held to it
    first = {}
    for remat, dev in ((None, "cuda"), (None, "cpu"), (32, "cuda")):
        extra = [] if remat is None else ["--remat-chunk", str(remat)]
        name = f"first{n}_remat{remat}_{dev}"
        recs, launches = run(name, CONFIG5_FLAGS + extra + [
            "--num-steps", str(n), "--log-every", "1", "--dropout", "0",
            "--eval-batches", "1", "--device", dev])
        first[remat, dev] = [r["loss"] for r in recs if "loss" in r]
        if len(first[remat, dev]) != n:
            fail(f"{name} logged {len(first[remat, dev])} losses, not {n}")
        if dev == "cuda":
            # n steps and one eval batch, every layer through the tiled
            # forward; without remat the tiled backward, with it the plain
            # recompute
            expect(launches, name, lstm_tiled_fwd=(n + 1) * L,
                   lstm_tiled_bwd=0 if remat else n * L)
            print(f"    launches {launches}", flush=True)
    for remat in (None, 32):
        a, b = first[remat, "cuda"], first[None, "cpu"]
        gap = max(abs(x - y) for x, y in zip(a, b))
        print(f"  remat_chunk={remat}, first {n} losses: card "
              f"{[round(x, 6) for x in a]}; CPU {[round(x, 6) for x in b]}; "
              f"max |d| {gap:.2e}", flush=True)
        if not gap <= TRAIN_LOSS_TOL:
            fail(f"config 5 (remat_chunk={remat}) card losses differ from "
                 f"the CPU run by {gap:.3e} > {TRAIN_LOSS_TOL}")

    # the main run: dropout 0.2, an eval cadence; every layer of every step
    # and eval batch through the tiled pair
    valid = get_dataset("wikitext103")["valid"]
    B, T = CONFIG5["B"], CONFIG5["T"]
    per_eval = min(CONFIG5_EVAL_BATCHES, lm_windows(valid, B, T)[2])
    n_evals = CONFIG5_STEPS // CONFIG5_EVAL_EVERY + 1  # the cadence, final
    recs, launches = run("main", CONFIG5_FLAGS + [
        "--num-steps", str(CONFIG5_STEPS), "--log-every", "25",
        "--eval-every", str(CONFIG5_EVAL_EVERY), "--eval-batches",
        str(CONFIG5_EVAL_BATCHES), "--dropout", "0.2", "--device", "cuda"])
    want = dict(lstm_tiled_fwd=(CONFIG5_STEPS + n_evals * per_eval) * L,
                lstm_tiled_bwd=CONFIG5_STEPS * L)
    print(f"  kernel launches {launches} (predicted {want}: "
          f"{CONFIG5_STEPS} steps x {L} layers, + {n_evals} evals x "
          f"{per_eval} batches x {L} layers forward)", flush=True)
    expect(launches, "main", **want)
    for r in recs:
        print(f"  {json.dumps(r)}", flush=True)
    logged = [r for r in recs if "loss" in r]
    final = recs[-1]
    if final.get("note") != "final" or not final.get("eval_ppl", 0) > 0:
        fail(f"the run did not end with a final eval record: {final}")
    if not all(r["loss"] == r["loss"] and r["loss"] < 1e9 for r in logged):
        fail("a logged loss is not finite")
    if not logged[-1]["loss"] < logged[0]["loss"]:
        fail(f"the loss did not fall: {logged[0]['loss']} -> "
             f"{logged[-1]['loss']}")
    sps = sorted(r["steps_per_sec"] for r in logged[1:])
    tps = sorted(r["tokens_per_sec"] for r in logged[1:])
    print(f"  loss at step {logged[0]['step']} {logged[0]['loss']:.6f}, at "
          f"step {logged[-1]['step']} {logged[-1]['loss']:.6f}; final "
          f"eval_loss {final['eval_loss']:.6f}, eval_ppl "
          f"{final['eval_ppl']:.4f}; steady state (median of the log windows "
          f"after the first) {sps[len(sps) // 2]:.2f} steps/s, "
          f"{tps[len(tps) // 2]:.1f} tokens/s", flush=True)

    # device idle share over 20 steps under torch.profiler, through the same
    # library calls the CLI makes
    from lstm_tensorspark_torch.data import lm_batch_stream
    from lstm_tensorspark_torch.models import lstm_lm as tlm
    from lstm_tensorspark_torch.train import (init_train_state, make_optimizer,
                                              make_train_step)
    from lstm_tensorspark_torch.train.loop import device_batches

    data = get_dataset("wikitext103")
    cfg = tlm.LMConfig(vocab_size=len(data["vocab"]), hidden_size=CONFIG5["H"],
                       num_layers=L, dropout=0.2)
    params = tlm.params_to(tlm.init_lm(torch.Generator().manual_seed(0), cfg),
                           device)
    gen = torch.Generator(device=device).manual_seed(1)
    opt = make_optimizer("adam", 1e-3, clip_norm=1.0)
    state = init_train_state(params, opt,
                             carries=tlm.init_carries(cfg, B, device=device))
    step = make_train_step(
        lambda p, b, c=None: tlm.lm_loss(p, b, cfg, carries=c,
                                         dropout_gen=gen), opt, stateful=True)
    batches = device_batches(lm_batch_stream(data["train"], B, T), device)
    for _ in range(5):
        state, m = step(state, next(batches))
    holder = [state]

    def twenty():
        s = holder[0]
        for _ in range(20):
            s, m = step(s, next(batches))
        holder[0] = s
        return m

    prof = device_profile(torch, twenty)
    if prof is None:
        print("  20 steps under torch.profiler: no device time recorded "
              "(idle share not measured)", flush=True)
    else:
        busy, wall, by_name, counts = prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"  20 config-5 steps under torch.profiler: device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall (idle share "
              f"{1 - busy / wall:.3f}); top: "
              + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top), flush=True)
        # where a step's time goes: the tiled kernels, the products outside
        # them (projections, head, dU, dW), everything else the device ran
        # (optimizer, elementwise, embedding, copies), and host time the
        # device work does not cover
        parts = {"tiled kernels": 0.0, "matmuls": 0.0, "other": 0.0}
        for k, v in by_name.items():
            if "lstm_tiled_" in k:
                parts["tiled kernels"] += v
            elif any(w in k.lower() for w in ("gemm", "cutlass", "xmma")):
                parts["matmuls"] += v
            else:
                parts["other"] += v
        parts["host, uncovered"] = wall - busy
        print("  a config-5 step, by part: " + "; ".join(
            f"{k} {v / 20:.3f} ms" for k, v in parts.items()), flush=True)
        per_launch = {}
        for kind in ("fwd", "bwd"):
            keys = [k for k in by_name if f"lstm_tiled_{kind}_kernel" in k]
            n = sum(counts[k] for k in keys)
            if n:
                per_launch[kind] = round(sum(by_name[k] for k in keys) / n, 4)
        print(f"  the tiled kernels' device ms a launch in these steps: "
              f"{per_launch}", flush=True)
    return {"fwd": launches["lstm_tiled_fwd"],
            "bwd": launches["lstm_tiled_bwd"]}


def weights_of(cd, tgen, params, cfg):
    return cd.decode_weights(params, tgen.fuse_layers(params, cfg),
                             cfg.tie_embeddings)


def reject_draft(torch, tlm, dcfg, wrong, device):
    """The all-reject draft: zero weights and one spiked head bias on token
    ``wrong`` (one the target does not emit), so every proposal is
    rejected."""
    params = tlm.init_lm(torch.Generator().manual_seed(0), dcfg)
    zero = {"embedding": torch.zeros_like(params["embedding"]),
            "layers": [type(l)(*(torch.zeros_like(t) for t in l))
                       for l in params["layers"]],
            "head": {k: torch.zeros_like(v)
                     for k, v in params["head"].items()}}
    zero["head"]["bias"][wrong] = 10.0
    return tlm.params_to(zero, device)


def spec_inputs(torch, cfg, dcfg, B, K, seed, device, accept):
    """Carries and latches of one spec window; with B >= 4 row 1 is dead on
    entry and rows 2 and 3 end their budget inside the window (1 and 2
    tokens left). The all-accept draft (the target itself) starts from the
    target's carries."""
    g = torch.Generator().manual_seed(seed)
    L, H, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    h = (torch.randn((L, B, H), generator=g) * 0.5).to(device)
    c = (torch.randn((L, B, H), generator=g) * 0.5).to(device)
    if accept:
        dh, dc = h.clone(), c.clone()
    else:
        shape = (dcfg.num_layers, B, dcfg.hidden_size)
        dh = (torch.randn(shape, generator=g) * 0.5).to(device)
        dc = (torch.randn(shape, generator=g) * 0.5).to(device)
    tok = torch.randint(0, V, (B,), generator=g, dtype=torch.int32).to(device)
    alive = torch.ones(B, dtype=torch.int32, device=device)
    rem = torch.full((B,), K + 4, dtype=torch.int32, device=device)
    eos = torch.full((B,), -1, dtype=torch.int32, device=device)
    if B >= 4:
        alive[1], rem[1] = 0, 0
        rem[2], rem[3] = 1, 2
    return [h, c, dh, dc, tok, alive, rem, eos]


def compare_spec(torch, cs, tw, dw, inputs, K, label):
    """Kernel vs plain version on the same inputs; returns the max abs
    difference of the four carry arrays and the tokens each row emitted."""
    got = cs.spec_window(tw, dw, *inputs, k_draft=K)
    ref = cs.spec_window_reference(tw, dw, *inputs, k_draft=K)
    torch.cuda.synchronize()
    names = ("h", "c", "draft h", "draft c", "tokens", "next", "alive",
             "remaining")
    for name, a, b in zip(names[4:], got[4:], ref[4:]):
        if not torch.equal(a, b):
            fail(f"{label}: kernel {name} differ from the plain version:\n"
                 f"kernel {a.tolist()}\nplain  {b.tolist()}")
    err = max(float((a - b).abs().max()) for a, b in zip(got[:4], ref[:4]))
    if err > TOL:
        fail(f"{label}: carries differ by {err:.3e} > {TOL}")
    return err, (got[4] != cs.PAD_TOKEN).sum(dim=0)


def spec_bound(cfg, dcfg, B, K, live, emitted):
    """Least time for one spec window: the larger of bytes over HBM
    bandwidth (both models' weights read once, embedding rows as gathered,
    carries in and out, the row vectors) and float32 FLOPs over the card's
    peak, counted for this run's data: K draft steps with the head per row
    live at entry, then, per emitted token, a target step with the head and
    a draft step without."""

    def cell(m):  # weights and products of the L fused cells
        return sum(((m.embed if l == 0 else m.hidden_size) + m.hidden_size)
                   * 4 * m.hidden_size for l in range(m.num_layers))

    V = cfg.vocab_size
    weights = sum(cell(m) + 4 * m.hidden_size * m.num_layers
                  + m.hidden_size * V + V for m in (cfg, dcfg))
    emb_rows = (min(emitted, V) * cfg.embed
                + min(K * live + emitted, V) * dcfg.embed)
    carries = 4 * B * (cfg.num_layers * cfg.hidden_size
                       + dcfg.num_layers * dcfg.hidden_size)
    ints = 4 * B + (K + 1) * B + 3 * B
    nbytes = 4 * (weights + emb_rows + carries + ints)
    flops = 2 * (K * live * (cell(dcfg) + dcfg.hidden_size * V)
                 + emitted * (cell(cfg) + cfg.hidden_size * V + cell(dcfg)))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def spec_kernel_phase(torch, tlm, tgen, cd, cs, draft_config, device):
    print("== phase 11: spec-window kernel vs plain version", flush=True)
    max_err = 0.0
    timings = {}
    drafts = ("random", "reject", "accept")
    for name, spec, cases, timed in (
            ("config1", CONFIG1,
             [(B, K, d, False) for B in (1, 8, 16) for K in (1, 2, 4)
              for d in drafts]
             + [(8, K, d, True) for K in (2, 4) for d in drafts], (16, 4)),
            ("config3", CONFIG3, [(4, 4, d, False) for d in drafts], (4, 4))):
        models = {}
        for i, (B, K, draft, tied) in enumerate(cases):
            if tied not in models:
                cfg = tlm.LMConfig(vocab_size=spec["vocab"],
                                   hidden_size=spec["hidden"],
                                   num_layers=spec["layers"],
                                   tie_embeddings=tied)
                params = tlm.params_to(tlm.init_lm(
                    torch.Generator().manual_seed(1), cfg), device)
                dcfg = draft_config(cfg)
                dparams = tlm.params_to(tlm.init_lm(
                    torch.Generator().manual_seed(2), dcfg), device)
                models[tied] = (cfg, weights_of(cd, tgen, params, cfg),
                                dcfg, weights_of(cd, tgen, dparams, dcfg))
            cfg, tw, dcfg, dw = models[tied]
            accept = draft == "accept"
            inputs = spec_inputs(torch, cfg, dcfg, B, K, 200 + i, device,
                                 accept)
            h, c, _, _, *rows = inputs
            # the target's own greedy tokens over the window
            own = cs.spec_window_reference(tw, tw, h, c, h, c, *rows,
                                           k_draft=K)[4]
            if accept:
                ddcfg, ddw = cfg, tw
            elif draft == "reject":
                seen = set(own[own >= 0].tolist())
                wrong = next(t for t in range(cfg.vocab_size)
                             if t not in seen)
                ddcfg = dcfg
                ddw = weights_of(cd, tgen, reject_draft(
                    torch, tlm, dcfg, wrong, device), dcfg)
            else:
                ddcfg, ddw = dcfg, dw
            # row 0's EOS id: the last token this window emits for it
            first = cs.spec_window_reference(tw, ddw, *inputs, k_draft=K)[4]
            inputs[7][0] = first[first[:, 0] >= 0, 0][-1]
            label = (f"{name} L={cfg.num_layers} H={cfg.hidden_size} "
                     f"V={cfg.vocab_size} tied={tied} draft={draft} "
                     f"(L={ddcfg.num_layers} H={ddcfg.hidden_size}) B={B} "
                     f"k_draft={K}")
            err, n_emit = compare_spec(torch, cs, tw, ddw, inputs, K, label)
            # every row but the dead one emits exactly 1 token against the
            # all-reject draft; the rows with no EOS and a budget past the
            # window emit all W against the all-accept draft
            live = [r for r in range(B) if B < 4 or r != 1]
            if draft == "reject" and not bool((n_emit[live] == 1).all()):
                fail(f"{label}: the all-reject draft's rows emitted "
                     f"{n_emit.tolist()} tokens, not 1 each")
            full = list(range(4, B))
            if accept and not bool((n_emit[full] == K + 1).all()):
                fail(f"{label}: the all-accept draft's rows emitted "
                     f"{n_emit.tolist()} tokens, not W={K + 1} each")
            max_err = max(max_err, err)
            print(f"  {label}: tokens identical, emitted per row "
                  f"{n_emit.tolist()}, max carry diff {err:.3e}", flush=True)
        if timed is None:
            continue
        B, K = timed
        cfg, tw, dcfg, dw = models[False]
        inputs = spec_inputs(torch, cfg, dcfg, B, K, 7, device, False)
        inputs[5].fill_(1)  # every row live, none at its budget end
        inputs[6].fill_(K + 4)
        _, n_emit = compare_spec(torch, cs, tw, dw, inputs, K, name)
        iters = 200 if name == "config1" else 10

        def kernel():
            return cs.spec_window(tw, dw, *inputs, k_draft=K)

        def plain():
            return cs.spec_window_reference(tw, dw, *inputs, k_draft=K)

        h, c, _, _, tok, alive, rem, eos = inputs

        def window():  # the plain decode window of W steps: a reference
            return cd.decode_window(tw, h, c, tok, alive, rem, eos, None,
                                    window=K + 1, temperature=1.0,
                                    greedy=True)

        plain_ms, kernel_ms, (p1, k1, k2, p2) = in_turns(
            torch, plain, kernel, iters)
        window_ms = time_ms(torch, window, iters)
        device_ms = profiled_ms(torch, kernel, "spec_window", 20)
        emitted = int(n_emit.sum())
        bound_ms, bound_by = spec_bound(cfg, dcfg, B, K, B, emitted)
        timings[name] = dict(B=B, K=K, kernel_ms=kernel_ms,
                             plain_ms=plain_ms, device_ms=device_ms,
                             window_ms=window_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        if name == "config1":  # every proposal accepted: W steps a row
            acc = spec_inputs(torch, cfg, cfg, B, K, 7, device, True)
            acc[5].fill_(1)
            acc[6].fill_(K + 4)
            _, acc_emit = compare_spec(torch, cs, tw, tw, acc, K, name)
            acc_ms = time_ms(torch, lambda: cs.spec_window(
                tw, tw, *acc, k_draft=K), iters)
            print(f"  {name} B={B} k_draft={K} all-accept draft (the target, "
                  f"{int(acc_emit.sum())} tokens emitted): kernel_ms "
                  f"{acc_ms:.4f}", flush=True)
        dev = "not recorded" if device_ms is None else f"{device_ms:.4f}"
        print(f"  {name} B={B} k_draft={K} (random draft, {emitted} tokens "
              f"emitted, per row {n_emit.tolist()}): kernel_ms "
              f"{kernel_ms:.4f} ({k1:.4f}, {k2:.4f}), device ms per launch "
              f"{dev}, plain_ms {plain_ms:.4f} ({p1:.4f}, {p2:.4f}), "
              f"bound_ms {bound_ms:.6f} ({bound_by}); the plain decode "
              f"window at K={K + 1}: kernel {window_ms:.4f} ms", flush=True)
    return max_err, timings


def spec_serve_phase(torch, tlm, tgen, cd, cs, cl, serve, draft_config,
                     device):
    print("== phase 12: speculative serving of config 1 over HTTP",
          flush=True)
    import numpy as np

    cfg, params_cpu, _ = make_model(torch, tlm, 0, device="cpu", **CONFIG1)
    dcfg = draft_config(cfg)
    dparams_cpu = tlm.init_lm(torch.Generator().manual_seed(1), dcfg)
    rng = np.random.RandomState(0)
    lens = (3, 9, 17, 24, 33, 40)
    prompts = [rng.randint(0, cfg.vocab_size, size=t).tolist() for t in lens]
    n_new = 32
    refs = [tgen.generate(params_cpu, [p], cfg, max_new_tokens=n_new,
                          greedy=True, device="cpu")[0, len(p):].tolist()
            for p in prompts]
    eos_at = next((i for i in range(8, n_new) if refs[5][i] not in refs[5][:i]),
                  None)
    if eos_at is None:
        fail(f"no token of {refs[5]} first appears at step 8 or later")
    eos = refs[5][eos_at]
    expect = [list(r) for r in refs]
    expect[5] = refs[5][:eos_at + 1]
    results = {}
    spec_launches = None
    for label, draft in (("plain", None), ("random draft", "random"),
                         ("all-accept draft", "accept")):
        engine = serve.ServeEngine(params_cpu, cfg, device=device,
                                   num_slots=32, rng_seed=0)
        kw = {}
        if draft is not None:
            if draft == "random":
                engine.attach_draft(dparams_cpu, dcfg)
            else:  # the target as its own draft
                engine.attach_draft(params_cpu, cfg)
            kw = dict(speculative=True, spec_ladder=(2, 4))
        server = serve.ServeServer(engine, max_active=16, **kw)
        server.warmup(prompt_lens=lens)
        torch.cuda.synchronize()
        httpd = serve.make_http_server(server, "127.0.0.1", 0)
        port = httpd.server_address[1]
        http_thread = threading.Thread(target=httpd.serve_forever,
                                       daemon=True)
        http_thread.start()

        def burst():
            out = [None] * len(prompts)

            def run(i):
                body = {"prompt": prompts[i], "max_new_tokens": n_new,
                        "greedy": True}
                if i == 5:
                    body["eos_id"] = eos
                out[i] = post(port, body)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            if any(t.is_alive() for t in threads):
                fail(f"{label}: a request did not finish")
            for i, r in enumerate(out):
                if r is None or r[0] != 200:
                    fail(f"{label}: request {i} failed: {r}")
                if r[1]["tokens"] != expect[i]:
                    fail(f"{label}: request {i}: served tokens "
                         f"{r[1]['tokens']} != plain generate on the CPU "
                         f"{expect[i]}")
            return out, time.perf_counter() - t0

        try:
            with server:
                before = server.stats()["batcher"]
                for counts in (cd.counts, cs.counts, cl.fwd_counts):
                    counts.reset()
                out, wall = burst()
                launches = {"spec_window": cs.counts.kernel,
                            "decode_window": cd.counts.kernel,
                            "lstm_fwd": cl.fwd_counts.kernel}
                plain_runs = cs.counts.reference + cd.counts.reference
                after = server.stats()["batcher"]
                prof = device_profile(torch, burst)
        finally:
            httpd.shutdown()
            httpd.server_close()
            http_thread.join(30)
        if plain_runs != 0:
            fail(f"{label}: {plain_runs} windows ran the plain version on "
                 "the card")
        if launches["lstm_fwd"] < 1:
            fail(f"{label}: the prefills launched the lstm_fwd kernel no time")
        spec_windows = (sum(after["spec_windows_dispatched"].values())
                        - sum(before["spec_windows_dispatched"].values()))
        accepted = (after["spec_accepted_tokens"]
                    - before["spec_accepted_tokens"])
        rows = after["spec_rows_verified"] - before["spec_rows_verified"]
        if draft is not None:
            if spec_windows < 1:
                fail(f"{label}: the burst dispatched no speculative window")
            if launches["spec_window"] != spec_windows:
                fail(f"{label}: {launches['spec_window']} spec kernel "
                     f"launches != {spec_windows} spec windows dispatched")
            if after["draft_prefill_failures"] != 0:
                fail(f"{label}: {after['draft_prefill_failures']} draft "
                     "prefills failed")
            if spec_launches is None:
                spec_launches = launches["spec_window"]
        elif launches["spec_window"] != 0:
            fail("the plain burst launched the spec kernel")
        tokens = sum(len(r[1]["tokens"]) for r in out)
        ttft = sorted(r[1]["ttft_ms"] for r in out)
        itl = sorted(r[1]["max_itl_ms"] or 0.0 for r in out)
        results[label] = tokens / wall
        line = (f"  {label}: 6 requests, tokens identical to the plain "
                f"generate on the CPU; {tokens} tokens in {wall:.3f} s = "
                f"{tokens / wall:.1f} tokens/s; launches {launches}")
        if draft is not None:
            line += (f"; spec windows {spec_windows} (by K_draft "
                     f"{after['spec_windows_dispatched']}), "
                     f"mean accepted length "
                     f"{accepted / max(rows, 1):.3f} ({accepted} accepted "
                     f"over {rows} row-windows), draft prefills "
                     f"{after['draft_prefills_dispatched']} "
                     f"(failures {after['draft_prefill_failures']})")
        print(line, flush=True)
        print(f"  {label}: ttft_ms {ttft} (median {ttft[len(ttft) // 2]}); "
              f"max_itl_ms {itl}", flush=True)
        if prof is None:
            print(f"  {label} under torch.profiler: no device time recorded "
                  "(device idle share not measured)", flush=True)
        else:
            busy, pwall, by_name, _ = prof
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            print(f"  {label} burst under torch.profiler: device busy "
                  f"{busy:.3f} ms of {pwall:.3f} ms wall (idle share "
                  f"{1 - busy / pwall:.3f}); top: "
                  + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top),
                  flush=True)
    print(f"  tokens/s: spec (random draft) / plain "
          f"{results['random draft'] / results['plain']:.3f}, spec "
          f"(all-accept draft) / plain "
          f"{results['all-accept draft'] / results['plain']:.3f}",
          flush=True)
    return spec_launches


def main() -> int:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA card")
    try:
        from lstm_tensorspark_torch import cli, configure_precision, kernels
        from lstm_tensorspark_torch import serve
        from lstm_tensorspark_torch.models import generate as tgen
        from lstm_tensorspark_torch.models import lstm_lm as tlm
        from lstm_tensorspark_torch.ops import cuda_decode as cd
        from lstm_tensorspark_torch.ops import cuda_lstm as cl
        from lstm_tensorspark_torch.ops import cuda_lstmx as cx
        from lstm_tensorspark_torch.ops import cuda_lstm_tiled as ct
        from lstm_tensorspark_torch.ops import cuda_spec as cs
        from lstm_tensorspark_torch.train.distill import draft_config
    except ImportError as e:
        fail(f"the port is not importable (run from the repo root): {e}")

    print("== phase 1: versions and card", flush=True)
    card = card_line()
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f", count {torch.cuda.device_count()}", flush=True)
    print(f"  nvidia-smi: {card}", flush=True)
    configure_precision()
    device = torch.device("cuda", 0)

    print("== phase 2: build the CUDA kernels", flush=True)
    sources = kernels.SOURCES
    secs = kernels.build(sources)
    print(f"  {', '.join(n + '.cu' for n in sources)} built in {secs:.2f} s",
          flush=True)
    for name in sources:
        log = kernels.library_path(name).with_name(
            kernels.library_path(name).name + ".log")
        if log.is_file():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}", flush=True)

    max_err, timings = kernel_phase(torch, tlm, tgen, cd, device)
    launches, tokens = serve_phase(torch, tlm, tgen, cd, serve, device)
    lstm_timings = lstm_kernel_phase(torch, cl, device)
    train_launches = train_phase(torch, cli, cl, device)
    lstmx_timings = lstmx_kernel_phase(torch, cx, device)
    config2_launches = config2_phase(torch, cli, cl, cx, ct, device)
    tiled_timings = tiled_kernel_phase(torch, cl, ct, device)
    config5_launches = config5_phase(torch, cli, cl, cx, ct, device)
    spec_err, spec_timings = spec_kernel_phase(torch, tlm, tgen, cd, cs,
                                               draft_config, device)
    spec_launches = spec_serve_phase(torch, tlm, tgen, cd, cs, cl, serve,
                                     draft_config, device)

    main_path = timings["config1"]
    lstm_rows = [{
        "name": f"lstm_{kind}",
        "route": "cuda",
        "source": f"lstm_tensorspark_torch/csrc/lstm_{kind}.cu",
        "replaces": ("lstm_tensorspark_tpu/ops/pallas_lstm.py:528"
                     if kind == "fwd"
                     else "lstm_tensorspark_tpu/ops/pallas_lstm.py:597"),
        "launches": train_launches[kind],
        "max_abs_err": lstm_timings[kind]["max_err"],
        "ms": lstm_timings[kind]["kernel_ms"],
        "plain_ms": lstm_timings[kind]["plain_ms"],
        "bound_ms": lstm_timings[kind]["bound_ms"],
        "bound_by": lstm_timings[kind]["bound_by"],
        "library_ms": lstm_timings[kind]["library_ms"],
    } for kind in ("fwd", "bwd")]
    replaces = {
        "lstmx_fwd": "lstm_tensorspark_tpu/ops/pallas_lstm.py:383",
        "lstmx_bwd": "lstm_tensorspark_tpu/ops/pallas_lstm.py:444",
        "bilstm_fwd": "lstm_tensorspark_tpu/ops/pallas_bilstm.py:108",
        "bilstm_bwd": "lstm_tensorspark_tpu/ops/pallas_bilstm.py:178",
    }
    lstmx_rows = [{
        "name": role,
        "route": "cuda",
        "source": ("lstm_tensorspark_torch/csrc/lstmx_"
                   f"{role.split('_')[1]}.cu"),
        "replaces": replaces[role],
        "launches": config2_launches[role],
        "max_abs_err": lstmx_timings[role]["max_err"],
        "ms": lstmx_timings[role]["kernel_ms"],
        "plain_ms": lstmx_timings[role]["plain_ms"],
        "bound_ms": lstmx_timings[role]["bound_ms"],
        "bound_by": lstmx_timings[role]["bound_by"],
        "library_ms": lstmx_timings[role]["library_ms"],
    } for role in replaces]
    tiled_rows = [{
        "name": f"lstm_tiled_{kind}",
        "route": "cuda",
        "source": f"lstm_tensorspark_torch/csrc/lstm_tiled_{kind}.cu",
        "replaces": ("lstm_tensorspark_tpu/ops/pallas_lstm.py:670"
                     if kind == "fwd"
                     else "lstm_tensorspark_tpu/ops/pallas_lstm.py:744"),
        "launches": config5_launches[kind],
        "max_abs_err": tiled_timings[kind]["max_err"],
        "ms": tiled_timings[kind]["kernel_ms"],
        "plain_ms": tiled_timings[kind]["plain_ms"],
        "bound_ms": tiled_timings[kind]["bound_ms"],
        "bound_by": tiled_timings[kind]["bound_by"],
        "library_ms": tiled_timings[kind]["library_ms"],
    } for kind in ("fwd", "bwd")]
    print(json.dumps({"kernels": [{
        "name": "decode_window",
        "route": "cuda",
        "source": "lstm_tensorspark_torch/csrc/decode_window.cu",
        "replaces": "lstm_tensorspark_tpu/ops/pallas_decode.py:109",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_path["kernel_ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": None,
    }, {
        "name": "spec_window",
        "route": "cuda",
        "source": "lstm_tensorspark_torch/csrc/spec_window.cu",
        "replaces": "lstm_tensorspark_tpu/ops/pallas_decode.py:367",
        "launches": spec_launches,
        "max_abs_err": spec_err,
        "ms": spec_timings["config1"]["kernel_ms"],
        "plain_ms": spec_timings["config1"]["plain_ms"],
        "bound_ms": spec_timings["config1"]["bound_ms"],
        "bound_by": spec_timings["config1"]["bound_by"],
        "library_ms": None,
    }] + lstm_rows + lstmx_rows + tiled_rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
