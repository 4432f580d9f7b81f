"""Where the residentx kernels spend a step: phase clocks on the card.

    python -m lstm_tensorspark_torch.phase_clocks

Builds ``csrc/lstmx_fwd.cu`` and ``csrc/lstmx_bwd.cu`` with
``-DLSTMX_PHASE_CLOCKS`` (libraries of their own beside the plain ones):
the ``CLK_MARK`` points in the sources then make thread 0 of block 0 add
``clock64()`` deltas per phase into a device array. Runs each kernel
through its wrapper at config 2's shapes (one direction unmasked, two
directions masked) and the LM's at ``--seq-len 256``, and prints the SM
cycles per step of each phase. The marks sit after the barriers that end
each phase, so a phase's count includes waiting for the slowest thread
(and, at the cluster barrier, the slowest block). Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from . import kernels
from .ops import cuda_lstmx as cx

MACRO = "LSTMX_PHASE_CLOCKS"
PHASES = {"lstmx_fwd": ("stage", "projection", "h@U", "cell", "cluster.sync"),
          "lstmx_bwd": ("stage+rebuild z", "gate algebra", "cluster.sync",
                        "dz@U^T")}


def _read(name: str) -> list[int]:
    """The cycle sums of kernel ``name``'s instrumented build since the
    last read (which clears them)."""
    fn = kernels.load(name).lstmx_phase_clocks
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 16)()
    torch.cuda.synchronize()
    if fn(ctypes.addressof(buf)) != 0:
        raise RuntimeError(f"{name}: reading the phase clocks failed")
    return list(buf)


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
    print(f"B={B} T={T} D={D} H={H} ndir={ndir} mask={masked} "
          f"{cx.card_plan(B, H, D, ndir, dev)}")
    for name, clk in (("lstmx_fwd", fwd), ("lstmx_bwd", bwd)):
        n = len(PHASES[name])
        total = sum(clk[:n])
        print(f"  {name}: {total / T:.0f} SM cycles per step: " + ", ".join(
            f"{p} {c / T:.0f} ({c / total:.0%})"
            for p, c in zip(PHASES[name], clk[:n])), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_clocks: needs a CUDA card", file=sys.stderr)
        return 1
    from .device import configure_precision

    configure_precision()
    dev = torch.device("cuda", 0)
    with kernels.defined(MACRO):
        kernels.build(list(PHASES))
        _case(32, 400, 256, 256, 1, False, dev)
        _case(32, 400, 256, 256, 2, True, dev)
        _case(64, 256, 128, 128, 1, False, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
