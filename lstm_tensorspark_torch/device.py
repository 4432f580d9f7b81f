"""Device choice and float32 precision policy — the one place both live.

Every entry point takes ``device`` (default ``"cuda"``) and passes it
through :func:`resolve_device`, which refuses a CUDA device when no card is
present rather than running silently on the CPU. :func:`configure_precision`
turns TF32 off for matmuls and cuDNN and pins the float32 matmul precision
at ``"highest"``, so the port's float32 numbers are float32 on the card as
they are in the JAX reference (TF32 keeps about three decimal digits).
"""

from __future__ import annotations

import torch


def configure_precision() -> None:
    """Full float32 matmuls everywhere (no TF32). Idempotent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is available (a caller who wants the CPU says ``"cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
