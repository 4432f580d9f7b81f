"""Parameter conversion between the JAX package's pytrees and the port.

The input of :func:`params_from_numpy` is the JAX LM parameter pytree after
``jax.tree.map(np.asarray, params)``: ``embedding``, ``layers`` (one object
per layer carrying the 12 per-gate arrays as attributes ``W_i`` … ``b_o`` —
read by name, so the JAX class is never imported; plain mappings work too)
and ``head`` (``kernel`` and ``bias``, or ``bias`` alone for a tied head).
:func:`classifier_params_from_numpy` takes the bi-LSTM classifier's
(``embedding``, ``fwd`` and ``bwd`` lists of layers, ``head``). Both
directions copy the values bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.lstm_cell import LSTMParams

_GATE_FIELDS = LSTMParams._fields


def _field(layer, name):
    if isinstance(layer, dict):
        return layer[name]
    return getattr(layer, name)


def _tensor(a, device) -> torch.Tensor:
    arr = np.array(a, dtype=np.float32, copy=True)  # writable, owned copy
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree, device: str | torch.device = "cuda") -> dict:
    """JAX LM params (numpy leaves) → the port's parameter dict on
    ``device``."""
    dev = resolve_device(device)
    layers = _layers(tree["layers"], dev)
    head = {k: _tensor(v, dev) for k, v in tree["head"].items()}
    return {"embedding": _tensor(tree["embedding"], dev), "layers": layers,
            "head": head}


def _layers(layers, dev):
    return [LSTMParams(*(_tensor(_field(layer, f), dev) for f in _GATE_FIELDS))
            for layer in layers]


def classifier_params_from_numpy(tree, device: str | torch.device = "cuda") -> dict:
    """JAX classifier params (numpy leaves) → the port's dict on
    ``device``."""
    dev = resolve_device(device)
    return {"embedding": _tensor(tree["embedding"], dev),
            "fwd": _layers(tree["fwd"], dev), "bwd": _layers(tree["bwd"], dev),
            "head": {k: _tensor(v, dev) for k, v in tree["head"].items()}}


def classifier_params_to_numpy(params) -> dict:
    """The port's classifier dict → numpy leaves, layers as dicts keyed by
    the 12 gate-field names."""
    def arr(t):
        return t.detach().cpu().numpy().copy()

    def layers(ls):
        return [{f: arr(getattr(layer, f)) for f in _GATE_FIELDS} for layer in ls]

    return {"embedding": arr(params["embedding"]), "fwd": layers(params["fwd"]),
            "bwd": layers(params["bwd"]),
            "head": {k: arr(v) for k, v in params["head"].items()}}


def params_to_numpy(params) -> dict:
    """The port's parameter dict → numpy leaves, layers as dicts keyed by
    the 12 gate-field names (``W_i`` … ``b_o``)."""
    def arr(t):
        return t.detach().cpu().numpy().copy()

    return {
        "embedding": arr(params["embedding"]),
        "layers": [{f: arr(getattr(layer, f)) for f in _GATE_FIELDS}
                   for layer in params["layers"]],
        "head": {k: arr(v) for k, v in params["head"].items()},
    }
