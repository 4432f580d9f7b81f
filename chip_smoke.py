#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``lstm_tensorspark_torch``).

Run from the root of a checkout on a machine with one NVIDIA card::

    python3 chip_smoke.py

Phases (each one fails the run):

1. versions, and the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the serve path from ``csrc/`` (``nvcc``);
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
   plain version on the card.

The last lines are the kernel report (one JSON object), the card's
``name, power.limit`` line, and ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, without a card or without the package.
"""

from __future__ import annotations

import http.client
import json
import subprocess
import sys
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
    ms summed over all kernels and copies, wall ms, {name: device ms}) —
    or None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
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
    if not by_name:
        return None
    return sum(by_name.values()), wall * 1e3, by_name


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
            busy, wall, by_name = prof
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
        busy, pwall, by_name = prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"  serve burst under torch.profiler: device busy {busy:.3f} ms "
              f"of {pwall:.3f} ms wall (idle share "
              f"{1 - busy / pwall:.3f}); top: "
              + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top), flush=True)
    return launches, tokens


def main() -> int:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA card")
    try:
        from lstm_tensorspark_torch import configure_precision, kernels
        from lstm_tensorspark_torch import serve
        from lstm_tensorspark_torch.models import generate as tgen
        from lstm_tensorspark_torch.models import lstm_lm as tlm
        from lstm_tensorspark_torch.ops import cuda_decode as cd
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
    secs = kernels.build(["decode_window"])
    log = kernels.library_path("decode_window").with_name(
        kernels.library_path("decode_window").name + ".log")
    print(f"  decode_window.cu built in {secs:.2f} s", flush=True)
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    max_err, timings = kernel_phase(torch, tlm, tgen, cd, device)
    launches, tokens = serve_phase(torch, tlm, tgen, cd, serve, device)

    main_path = timings["config1"]
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
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
