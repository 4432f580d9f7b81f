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
   plain version on the card;
5. hold the LSTM recurrence kernels (``csrc/lstm_fwd.cu``,
   ``csrc/lstm_bwd.cu``) against their plain PyTorch versions at config 1
   (B=64, T=64, H=128) and config 3's width (B=32, T=70, H=650), with and
   without a mask, from non-zero carries, the forward with and without
   residuals; time config 1 in turns (plain, kernel, kernel, plain) with
   CUDA events and under ``torch.profiler``, beside cuDNN's
   ``torch.nn.LSTM`` on the same shapes (the yardstick; the port never
   calls it) and the bound;
6. train config 1 through the CLI entry (``cli.main(["train", ...])``):
   the first 10 losses on the card against the same run on the CPU (plain
   versions, same seed and batches), and 5 of a 2-layer stack, then 300 steps with an eval every 100
   whose kernel launch counts must equal steps × layers (+ the eval
   forwards), steps/s and tokens/s, and the device idle share over 20
   steps under ``torch.profiler``.

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


def cudnn_yardstick(torch, cl, inputs, cots):
    """cuDNN's ``torch.nn.LSTM`` on one layer at the same B, T, H: input
    weights W [H, 4H] and bias b drawn here, U copied across (the gate order
    i, f, g, o is the same in both; ``bias_hh`` is 0), TF32 off. It computes
    the same function as the kernel fed ``xproj = x @ W + b``, plus that
    input product; its backward also gives dW, dU, db and dx. Returns
    (forward ms, backward-alone ms, forward + backward ms, max |ys - ys of
    the forward kernel|, and the port's whole layer forward + backward ms:
    ``cuda_lstm_scan`` through both kernels and the matmuls around them,
    the same function as cuDNN's forward + backward)."""
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
    kys = cl.lstm_forward((x @ W + b).contiguous(), U, h0, c0)[0]
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
        (h, c), y = cl.cuda_lstm_scan(lp, xs, (h0g, c0g))
        return torch.autograd.grad([y, h, c], [*gates, xs, h0g, c0g],
                                   port_out)

    return (time_ms(torch, fwd, 50), time_ms(torch, bwd, 50),
            time_ms(torch, both, 50), diff, time_ms(torch, port_both, 50))


def lstm_kernel_phase(torch, cl, device):
    print("== phase 5: LSTM recurrence kernels vs plain versions", flush=True)
    errs = {"fwd": 0.0, "bwd": 0.0}
    for name, spec in (("config1", LSTM_CONFIG1), ("config3", LSTM_CONFIG3)):
        B, T, H = spec["B"], spec["T"], spec["H"]
        for masked in (False, True):
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
        torch, cl, inputs, (dys, dhT, dcT))
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
            dev_ms = sum(v for k, v in prof[2].items()
                         if f"lstm_{kind}_kernel" in k) / 20
        timings[kind] = dict(kernel_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                             bound_ms=bound_ms, bound_by=bound_by,
                             device_ms=dev_ms,
                             library_ms=lib_fwd if kind == "fwd" else lib_bwd,
                             max_err=errs[kind])
        print(f"  lstm_{kind} config1: kernel_ms {timings[kind]['kernel_ms']:.4f}"
              f" ({k1:.4f}, {k2:.4f}), device_ms "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'}, "
              f"plain_ms {timings[kind]['plain_ms']:.4f} ({p1:.4f}, {p2:.4f}),"
              f" library_ms {timings[kind]['library_ms']:.4f}, bound_ms "
              f"{bound_ms:.6f} ({bound_by}); the T={T} dependent steps are a "
              "latency floor the bound does not see", flush=True)
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
        busy, wall, by_name = prof
        idle = 1 - busy / wall
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"  20 steps under torch.profiler: device busy {busy:.3f} ms "
              f"of {wall:.3f} ms wall (idle share {idle:.3f}); top: "
              + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top), flush=True)
    return launches


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
    sources = ["decode_window", "lstm_fwd", "lstm_bwd"]
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
    }] + lstm_rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
