"""Where the recurrence kernels spend a step: phase clocks on the card.

    python -m lstm_tensorspark_torch.phase_clocks [resident] [residentx] [forward] [tiled] [clusters] [windows] [spec]

Builds the resident pair ``csrc/lstm_fwd.cu`` / ``lstm_bwd.cu``, the
residentx pair ``csrc/lstmx_fwd.cu`` / ``lstmx_bwd.cu`` and the tiled
pair ``csrc/lstm_tiled_fwd.cu`` / ``lstm_tiled_bwd.cu`` with
``-DPHASE_CLOCKS`` (libraries of their own beside the plain ones): the
``CLK_MARK`` / ``CLK_MARK_AT`` points in the sources then make one thread
of block 0 add ``clock64()`` deltas per phase into a device array
(``csrc/cluster_common.cuh``). Runs the resident pair at config 1 (B=64,
T=64, H=128; the backward from the forward's residuals), the residentx
pair through its wrappers at config 2's shapes (one direction unmasked,
two directions masked) and the LM's at ``--seq-len 256``, and the tiled
pair at config 5's per-chip shard (B=16, T=128, H=1024), and prints
the SM cycles per step of each phase (the groups named on the command
line, or all). ``forward`` clocks the residentx forward alone as
``chip_smoke.py`` phase 7 times it: config 2 masked with the IMDB
stand-in's first batch, two directions with cs and one without.
``clusters`` is a design probe of the tiled pair's cluster size: at
config 5's shard and config 3's width (B=32, T=70, H=650) it runs each
kernel in clusters of 2 and of 4 (the plan narrowed to one size, where
that size fits), holds each against the plain version, and prints its
CUDA-event ms in turns (2, 4, 4, 2; the instrumented build) and its
phases. The marks sit after the barriers and waits that end each phase,
so a phase's count includes waiting for the slowest thread (and, at an
exchange, the slowest block). Each residentx kernel has two clocks: its
side kernel's (the forward's projection, the backward's z rebuild: block
0 runs one chunk of steps, printed per step of it) and its dependent
steps'. ``windows`` clocks the decode window (``csrc/decode_window.cu``)
at config 1 (B=16, K=8) and config 3's width (B=4, K=4): block 0's
prologue, its layers, the waits at the layers' barriers, its head slice,
the wait at the head's barrier, and the merge of the head's partials with
the latches. ``spec`` clocks the spec window (``csrc/spec_window.cu``,
greedy, a seeded random draft from ``draft_config``, every row live) at
config 1 (k_draft=4, B=16 and B=1) and config 3's width (B=4), summed over
the window: the prologue's copies as issued and as waited for, the propose
phase's layers, their barriers, its head, the head's barrier and merge,
its latches; the verify phase's target layers, draft layers, barriers,
head, head barrier and merge, latches; the epilogue.
Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys

import torch

from . import kernels
from .ops import cuda_lstm as cl
from .ops import cuda_lstm_tiled as ct
from .ops import cuda_lstmx as cx

MACRO = "PHASE_CLOCKS"
# each kernel's phases in the order of their marks (CLK_MARK(i) /
# CLK_MARK_AT(i, thread) in the source)
PHASES = {"lstm_fwd": ("h@U", "cell+stores", "h exchange"),
          "lstm_bwd": ("gate algebra+send dz", "factors+prefetch",
                       "dz wait", "dz@U^T+fold"),
          "lstmx_fwd": ("x@W", "zx stores", "h@U", "cell+send h",
                        "copy zx+wait h"),
          "lstmx_bwd": ("stage x", "x@W, stage h", "h@U", "factors",
                        "gate algebra", "dz exchange", "dz@U^T"),
          "lstm_tiled_fwd": ("wait+copy h", "h@U", "cell+stores"),
          "lstm_tiled_bwd": ("wait", "gather dh", "gate algebra+dz exchange",
                             "dz@U^T+slab"),
          "decode_window": ("prologue", "layers", "layer barriers", "head",
                            "head barrier", "merge+latches"),
          "spec_window": ("prologue copies", "prologue wait",
                          "propose layers", "propose barriers",
                          "propose head", "propose head barrier+merge",
                          "propose latches", "verify target layers",
                          "verify draft layers", "verify barriers",
                          "verify head", "verify head barrier+merge",
                          "verify latches", "epilogue")}
# the kernels each group of the command line runs
GROUPS = {"resident": ("lstm_fwd", "lstm_bwd"), "residentx": ("lstmx_fwd", "lstmx_bwd"),
          "forward": ("lstmx_fwd",),
          "tiled": ("lstm_tiled_fwd", "lstm_tiled_bwd"),
          "clusters": ("lstm_tiled_fwd", "lstm_tiled_bwd"),
          "windows": ("decode_window",), "spec": ("spec_window",)}
# the marks' streams, in mark order: (name, number of marks, what one
# pass is); a stream's marks are kept by one thread of block 0 of one
# kernel (lstmx_fwd.cu: its projection, one block per chunk of steps, then
# its dependent steps; lstmx_bwd.cu: its z rebuild, then its chain)
STREAMS = {"lstmx_fwd": (("projection", 2, "chunk"), ("chain", 3, "step")),
           "lstmx_bwd": (("rebuild", 4, "chunk"), ("chain", 3, "step")),
           "spec_window": (("block", 14, "window"),)}


def streams(name: str) -> tuple[tuple[str, int, str], ...]:
    """Kernel ``name``'s clock streams."""
    return STREAMS.get(name, (("block", len(PHASES[name]), "step"),))


def _read(name: str) -> list[int]:
    """The cycle sums of kernel ``name``'s instrumented build since the
    last read (which clears them)."""
    fn = kernels.load(name).kernel_phase_clocks
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 16)()
    torch.cuda.synchronize()
    if fn(ctypes.addressof(buf)) != 0:
        raise RuntimeError(f"{name}: reading the phase clocks failed")
    return list(buf)


def _print(name: str, clk: list[int], T: int, chunk: int = 1) -> None:
    """Cycles per step of each phase; a stream that one block runs once
    per chunk of ``chunk`` steps is divided by ``chunk``; a ``window``
    stream is printed per window."""
    i = 0
    for stream, n, unit in streams(name):
        names, vals = PHASES[name][i:i + n], clk[i:i + n]
        per = T if unit == "step" else chunk
        total = sum(vals)
        label = name if len(streams(name)) == 1 else f"{name} {stream}"
        what = "window" if unit == "window" else "step"
        print(f"  {label}: {total / per:.0f} SM cycles per {what}: " + ", ".join(
            f"{p} {c / per:.0f} ({c / max(total, 1):.0%})"
            for p, c in zip(names, vals)), flush=True)
        i += n


def _resident(B, T, H, dev):
    g = torch.Generator().manual_seed(0)
    xproj = torch.randn(T, B, 4 * H, generator=g).to(dev)
    U = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev)
    h0 = torch.zeros(B, H, device=dev)
    dys = torch.randn(T, B, H, generator=g).to(dev)
    _, _, _, z, cs = cl.lstm_forward(xproj, U, h0, h0, save_residuals=True)
    _read("lstm_fwd")  # the first launch's clocks are not kept
    cl.lstm_forward(xproj, U, h0, h0, save_residuals=True)
    fwd = _read("lstm_fwd")
    args = (z, h0, cs, dys, U, h0, h0)
    cl.lstm_backward(*args)
    _read("lstm_bwd")
    cl.lstm_backward(*args)
    bwd = _read("lstm_bwd")
    sms = cl._num_sms(dev)
    print(f"B={B} T={T} H={H} fwd {cl.plan('fwd', B, H, sms)} bwd "
          f"{cl.card_plan('bwd', B, H, dev)}")
    _print("lstm_fwd", fwd, T)
    _print("lstm_bwd", bwd, T)


def _case(B, T, D, H, ndir, masked, dev):
    g = torch.Generator().manual_seed(0)
    BS, G = ndir * B, 4 * H
    t = [torch.randn(T, BS, D, generator=g),
         torch.randn(ndir, D, G, generator=g) / D ** 0.5,
         torch.randn(ndir, G, generator=g) * 0.1,
         torch.randn(ndir, H, G, generator=g) / H ** 0.5,
         torch.zeros(BS, H), torch.zeros(BS, H)]
    mask = None
    if masked:
        lens = torch.randint(20, T + 1, (BS,), generator=g)
        mask = (torch.arange(T)[:, None] < lens[None, :]).float()
    xs, W, b, U, h0, c0 = (a.to(dev) for a in t)
    mask = None if mask is None else mask.to(dev)
    dys = torch.randn(T, BS, H, generator=g).to(dev)
    ys, _, _, cs = cx.lstmx_forward(xs, W, b, U, h0, c0, mask, save_c=True)
    _read("lstmx_fwd")  # the first launch's clocks are not kept
    cx.lstmx_forward(xs, W, b, U, h0, c0, mask, save_c=True)
    fwd = _read("lstmx_fwd")
    args = (xs, ys, h0, cs, c0, dys, W, b, U, torch.zeros_like(h0),
            torch.zeros_like(c0), mask)
    cx.lstmx_backward(*args)
    _read("lstmx_bwd")
    cx.lstmx_backward(*args)
    bwd = _read("lstmx_bwd")
    plan = cx.card_plan(B, H, D, ndir, dev)
    print(f"B={B} T={T} D={D} H={H} ndir={ndir} mask={masked} {plan}")
    _print("lstmx_fwd", fwd, T, plan.fwd.chunk)
    _print("lstmx_bwd", bwd, T, plan.bwd.chunk)


def _forward(dev):
    """The residentx forward at config 2 (B=32, T=400, D=H=256), masked
    with the lengths of the IMDB stand-in's first training batch: two
    directions with cs, then one without (phase 7's roles)."""
    from .data import get_dataset, padded_batches

    B, T, D, H = 32, 400, 256, 256
    seqs, labels = get_dataset("imdb", max_len=T)["train"]
    lens = torch.as_tensor(next(padded_batches(
        seqs, labels, B, T, shuffle_seed=0))["lengths"])
    m = (torch.arange(T)[:, None] < lens[None, :]).float()
    for ndir, save_c in ((2, True), (1, False)):
        g = torch.Generator().manual_seed(7)
        BS, G = ndir * B, 4 * H
        xs, W, b, U = (torch.randn(T, BS, D, generator=g),
                       torch.randn(ndir, D, G, generator=g) / D ** 0.5,
                       torch.randn(ndir, G, generator=g) * 0.1,
                       torch.randn(ndir, H, G, generator=g) / H ** 0.5)
        mask = m if ndir == 1 else torch.cat([m, torch.flip(m, (0,))], 1)
        args = [a.to(dev) for a in (xs, W, b, U, torch.zeros(BS, H),
                                    torch.zeros(BS, H), mask)]
        cx.lstmx_forward(*args, save_c=save_c)
        _read("lstmx_fwd")  # the first launch's clocks are not kept
        cx.lstmx_forward(*args, save_c=save_c)
        plan = cx.card_plan(B, H, D, ndir, dev)
        print(f"B={B} T={T} D={D} H={H} ndir={ndir} IMDB mask, cs={save_c} "
              f"{plan.fwd}")
        _print("lstmx_fwd", _read("lstmx_fwd"), T, plan.fwd.chunk)


def _tiled(B, T, H, dev):
    g = torch.Generator().manual_seed(0)
    xproj = torch.randn(T, B, 4 * H, generator=g).to(dev)
    U = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev)
    h0 = torch.zeros(B, H, device=dev)
    dys = torch.randn(T, B, H, generator=g).to(dev)
    _, _, _, z, cs = ct.lstm_tiled_forward(xproj, U, h0, h0,
                                           save_residuals=True)
    _read("lstm_tiled_fwd")  # the first launch's clocks are not kept
    ct.lstm_tiled_forward(xproj, U, h0, h0, save_residuals=True)
    fwd = _read("lstm_tiled_fwd")
    args = (z, h0, cs, dys, U, h0, h0)
    ct.lstm_tiled_backward(*args)
    _read("lstm_tiled_bwd")
    ct.lstm_tiled_backward(*args)
    bwd = _read("lstm_tiled_bwd")
    sms = cl._num_sms(dev)
    print(f"B={B} T={T} H={H} fwd {ct.plan('fwd', B, H, sms)} bwd "
          f"{ct.plan('bwd', B, H, sms)}")
    _print("lstm_tiled_fwd", fwd, T)
    _print("lstm_tiled_bwd", bwd, T)


def _ms(fn, iters: int) -> float:
    """Mean CUDA-event ms of ``fn`` over ``iters`` calls after one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _window(vocab, hidden, layers, B, K, dev):
    """A greedy decode window of a seeded model (tokens from a plain
    version's run are not checked here: chip_smoke.py phase 3 does)."""
    from .models import generate as tgen
    from .models import lstm_lm as tlm
    from .ops import cuda_decode as cd

    cfg = tlm.LMConfig(vocab_size=vocab, hidden_size=hidden,
                       num_layers=layers)
    params = tlm.params_to(tlm.init_lm(torch.Generator().manual_seed(1),
                                       cfg), dev)
    w = cd.decode_weights(params, tgen.fuse_layers(params, cfg),
                          cfg.tie_embeddings)
    g = torch.Generator().manual_seed(7)
    h = (0.5 * torch.randn(layers, B, hidden, generator=g)).to(dev)
    c = (0.5 * torch.randn(layers, B, hidden, generator=g)).to(dev)
    rows = [torch.randint(0, vocab, (B,), generator=g).to(dev),
            torch.ones(B, dtype=torch.int32, device=dev),
            torch.full((B,), K + 3, dtype=torch.int32, device=dev),
            torch.full((B,), -1, dtype=torch.int32, device=dev)]
    run = lambda: cd.decode_window(w, h, c, *rows, None, window=K,
                                   temperature=1.0, greedy=True)
    run()
    _read("decode_window")  # the first launch's clocks are not kept
    run()
    print(f"decode window V={vocab} H={hidden} L={layers} B={B} K={K}: "
          f"{cd.card_plan(((layers, hidden, cfg.embed),), vocab, B, None, dev)}"
          " (the prologue is once a window, printed per step)")
    _print("decode_window", _read("decode_window"), K)


def _spec(vocab, hidden, layers, B, K, dev):
    """A spec window of a seeded target and a seeded random draft
    (``draft_config``), every row live with budget past the window (tokens
    are checked against the plain version by chip_smoke.py phase 11)."""
    from .models import generate as tgen
    from .models import lstm_lm as tlm
    from .ops import cuda_decode as cd
    from .ops import cuda_spec as cs
    from .train.distill import draft_config

    cfg = tlm.LMConfig(vocab_size=vocab, hidden_size=hidden,
                       num_layers=layers)
    dcfg = draft_config(cfg)
    w = []
    for seed, c in ((1, cfg), (2, dcfg)):
        params = tlm.params_to(tlm.init_lm(torch.Generator().manual_seed(seed),
                                           c), dev)
        w.append(cd.decode_weights(params, tgen.fuse_layers(params, c),
                                   c.tie_embeddings))
    g = torch.Generator().manual_seed(7)
    carries = [(0.5 * torch.randn(c.num_layers, B, c.hidden_size,
                                  generator=g)).to(dev)
               for c in (cfg, cfg, dcfg, dcfg)]
    rows = [torch.randint(0, vocab, (B,), generator=g).to(dev),
            torch.ones(B, dtype=torch.int32, device=dev),
            torch.full((B,), K + 4, dtype=torch.int32, device=dev),
            torch.full((B,), -1, dtype=torch.int32, device=dev)]
    run = lambda: cs.spec_window(*w, *carries, *rows, k_draft=K)
    run()
    _read("spec_window")  # the first launch's clocks are not kept
    toks = run()[4]
    steps = int((toks >= 0).any(dim=1).sum())
    models = ((layers, hidden, cfg.embed),
              (dcfg.num_layers, dcfg.hidden_size, dcfg.embed))
    print(f"spec window V={vocab} H={hidden} L={layers} draft H="
          f"{dcfg.hidden_size} B={B} k_draft={K} ({steps} verify steps): "
          f"{cd.card_plan(models, vocab, B, K, dev)}")
    _print("spec_window", _read("spec_window"), 1)


@contextlib.contextmanager
def _only(kind: str, C: int):
    """Inside the block the tiled ``kind`` kernel's plan tries clusters of
    C alone."""
    saved = ct.CLUSTERS[kind]
    ct.CLUSTERS[kind] = (C,)
    try:
        yield
    finally:
        ct.CLUSTERS[kind] = saved


def _clusters(B, T, H, dev):
    g = torch.Generator().manual_seed(1)
    xproj = torch.randn(T, B, 4 * H, generator=g).to(dev)
    U = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev)
    h0 = (0.5 * torch.randn(B, H, generator=g)).to(dev)
    c0 = (0.5 * torch.randn(B, H, generator=g)).to(dev)
    dys = torch.randn(T, B, H, generator=g).to(dev)
    ys, _, _, z, cs = cl.lstm_forward_reference(xproj, U, h0, c0,
                                                save_residuals=True)
    c_prev = torch.cat([c0[None], cs[:-1]])
    zero = torch.zeros_like(h0)
    dz = cl.lstm_backward_reference(z, c_prev, dys, U, zero, zero)[0]
    runs = {"fwd": (lambda: ct.lstm_tiled_forward(xproj, U, h0, c0,
                                                  save_residuals=True)[0], ys),
            "bwd": (lambda: ct.lstm_tiled_backward(z, c0, cs, dys, U, zero,
                                                   zero)[0], dz)}
    card = {kind: ct.card_plan(kind, B, H, dev).cluster for kind in runs}
    for kind, (run, ref) in runs.items():
        sizes = []
        for C in (2, 4):
            with _only(kind, C):
                try:
                    p = ct.card_plan(kind, B, H, dev)
                except ValueError:
                    continue
                sizes.append(C)
                d = (run() - ref).abs().max().item()
                tol = 1e-5 * max(1.0, ref.abs().max().item())
                if d > tol:
                    raise RuntimeError(f"tiled {kind} in clusters of {C} at "
                                       f"B={B} T={T} H={H}: max |d| {d:.2e} "
                                       f"> {tol:.2e}")
                _read(f"lstm_tiled_{kind}")
                run()
                print(f"B={B} T={T} H={H} {kind} clusters of {C} (max |d| "
                      f"{d:.2e}): {p}")
                _print(f"lstm_tiled_{kind}", _read(f"lstm_tiled_{kind}"), T)
        if sizes == [2, 4]:
            ms = {2: [], 4: []}
            for C in (2, 4, 4, 2):
                with _only(kind, C):
                    ms[C].append(_ms(run, 10))
            print(f"B={B} T={T} H={H} {kind} ms in turns: clusters of 2 "
                  f"{sum(ms[2]) / 2:.4f} ({ms[2][0]:.4f}, {ms[2][1]:.4f}), of "
                  f"4 {sum(ms[4]) / 2:.4f} ({ms[4][0]:.4f}, {ms[4][1]:.4f}); "
                  f"the card plan takes {card[kind]}", flush=True)


def main(argv=None) -> int:
    groups = list(sys.argv[1:] if argv is None else argv) or list(GROUPS)
    unknown = [g for g in groups if g not in GROUPS]
    if unknown:
        print(f"phase_clocks: unknown group(s) {unknown}; choose from "
              f"{list(GROUPS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("phase_clocks: needs a CUDA card", file=sys.stderr)
        return 1
    from .device import configure_precision

    configure_precision()
    dev = torch.device("cuda", 0)
    with kernels.defined(MACRO):
        kernels.build([n for g in groups for n in GROUPS[g]])
        if "resident" in groups:
            _resident(64, 64, 128, dev)
        if "residentx" in groups:
            _case(32, 400, 256, 256, 1, False, dev)
            _case(32, 400, 256, 256, 2, True, dev)
            _case(64, 256, 128, 128, 1, False, dev)
        if "forward" in groups:
            _forward(dev)
        if "tiled" in groups:
            _tiled(16, 128, 1024, dev)
        if "clusters" in groups:
            _clusters(16, 128, 1024, dev)
            _clusters(32, 70, 650, dev)
        if "windows" in groups:
            _window(50, 128, 1, 16, 8, dev)  # config 1
            _window(33278, 650, 2, 4, 4, dev)  # config 3's width
        if "spec" in groups:
            _spec(50, 128, 1, 16, 4, dev)  # config 1
            _spec(50, 128, 1, 1, 4, dev)
            _spec(33278, 650, 2, 4, 4, dev)  # config 3's width
    return 0


if __name__ == "__main__":
    sys.exit(main())
