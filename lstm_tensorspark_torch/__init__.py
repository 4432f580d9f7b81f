"""PyTorch/CUDA port of the LSTM LM framework (serving, and float32 training
of the LM), for NVIDIA Hopper (H100).

The package stands beside ``lstm_tensorspark_tpu`` (the JAX reference) and
imports nothing of it. Layouts at the public functions follow the JAX
package: ``x @ W`` with ``W`` ``[D, 4H]`` in gate order i, f, g, o, carries
``[L, B, H]`` float32, ``PAD_TOKEN = -1``.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
Hand-written kernels live in ``csrc/`` and are compiled with ``nvcc`` at
first use (``kernels.py``), never at import time.
"""

from .device import configure_precision, resolve_device

__all__ = ["configure_precision", "resolve_device"]
