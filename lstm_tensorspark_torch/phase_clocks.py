"""Where the recurrence kernels spend a step: phase clocks on the card.

    python -m lstm_tensorspark_torch.phase_clocks

Builds ``csrc/lstm_fwd.cu``, ``csrc/lstmx_fwd.cu`` and ``csrc/lstmx_bwd.cu``
with ``-DPHASE_CLOCKS`` (libraries of their own beside the plain ones): the
``CLK_MARK`` / ``CLK_MARK_AT`` points in the sources then make one thread
of block 0 add ``clock64()`` deltas per phase into a device array
(``csrc/cluster_common.cuh``). Runs the resident forward at config 1
(B=64, T=64, H=128), and the residentx pair through its wrappers at config
2's shapes (one direction unmasked, two directions masked) and the LM's at
``--seq-len 256``, and prints the SM cycles per step of each phase. The
marks sit after the barriers and waits that end each phase, so a phase's
count includes waiting for the slowest thread (and, at an exchange, the
slowest block). The backward has two clocks: its z rebuild's (block 0
runs one chunk of steps, printed per step of it) and its dependent
steps'.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from . import kernels
from .ops import cuda_lstm as cl
from .ops import cuda_lstmx as cx

MACRO = "PHASE_CLOCKS"
# each kernel's phases in the order of their marks (CLK_MARK(i) /
# CLK_MARK_AT(i, thread) in the source)
PHASES = {"lstm_fwd": ("h@U", "cell+stores", "h exchange"),
          "lstmx_fwd": ("stage", "projection", "h@U", "cell", "cluster.sync"),
          "lstmx_bwd": ("stage x", "x@W, stage h", "h@U", "factors",
                        "gate algebra", "dz exchange", "dz@U^T")}
# the marks' streams, in mark order: (name, number of marks, what one
# pass is); a stream's marks are kept by one thread of block 0 of one
# kernel (lstmx_bwd.cu: its z rebuild, one block per chunk of steps, then
# its dependent steps)
STREAMS = {"lstmx_bwd": (("rebuild", 4, "chunk"), ("chain", 3, "step"))}


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
    per chunk of ``chunk`` steps is divided by ``chunk``."""
    i = 0
    for stream, n, unit in streams(name):
        names, vals = PHASES[name][i:i + n], clk[i:i + n]
        per = T if unit == "step" else chunk
        total = sum(vals)
        label = name if len(streams(name)) == 1 else f"{name} {stream}"
        print(f"  {label}: {total / per:.0f} SM cycles per step: " + ", ".join(
            f"{p} {c / per:.0f} ({c / max(total, 1):.0%})"
            for p, c in zip(names, vals)), flush=True)
        i += n


def _resident(B, T, H, dev):
    g = torch.Generator().manual_seed(0)
    xproj = torch.randn(T, B, 4 * H, generator=g).to(dev)
    U = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev)
    h0 = torch.zeros(B, H, device=dev)
    cl.lstm_forward(xproj, U, h0, h0, save_residuals=True)
    _read("lstm_fwd")  # the first launch's clocks are not kept
    cl.lstm_forward(xproj, U, h0, h0, save_residuals=True)
    print(f"B={B} T={T} H={H} {cl.plan('fwd', B, H, cl._num_sms(dev))}")
    _print("lstm_fwd", _read("lstm_fwd"), T)


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
    _print("lstmx_fwd", fwd, T)
    _print("lstmx_bwd", bwd, T, plan.bwd.chunk)


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_clocks: needs a CUDA card", file=sys.stderr)
        return 1
    from .device import configure_precision

    configure_precision()
    dev = torch.device("cuda", 0)
    with kernels.defined(MACRO):
        kernels.build(list(PHASES))
        _resident(64, 64, 128, dev)
        _case(32, 400, 256, 256, 1, False, dev)
        _case(32, 400, 256, 256, 2, True, dev)
        _case(64, 256, 128, 128, 1, False, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
