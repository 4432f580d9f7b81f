"""Seq2seq encoder-decoder LSTM forecaster (BASELINE.md config 4:
multivariate electricity-load forecasting, one week of context → one day
of horizon).

Port of ``lstm_tensorspark_tpu/models/seq2seq.py``. The encoder is a
stacked LSTM over the context window (``ops/scan.stacked_lstm_scan``, with
``remat_chunk``); its final per-layer (h, c) carries start the decoder
stack. Training decodes teacher-forced: one scan a decoder layer over the
horizon (``ops/scan.auto_lstm_scan``, no remat: the horizon is short),
from the encoder's carries, so on the card the decoder's dh0 and dc0 flow
back into the encoder's backward as its dhT and dcT. Inference decodes
autoregressively: ``horizon`` steps of the plain cell (``lstm_step`` over
``fuse_params``), each fed the previous step's projection, as JAX's
``lax.scan`` runs it outside any kernel. ``compute_dtype`` ("float32" or
"bfloat16") reaches the recurrences alone; the projection reads h in
float32. Params are a plain dict, as in the JAX package::

    {"encoder": [LSTMParams, ...], "decoder": [LSTMParams, ...],
     "proj": {"kernel": [H, F], "bias": [F]}}
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.lstm_cell import (COMPUTE_DTYPES, LSTMParams, fuse_params,
                             glorot_uniform, init_lstm_params, lstm_step)
from ..ops.scan import auto_lstm_scan, stacked_lstm_scan


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    num_features: int
    hidden_size: int = 128
    num_layers: int = 1
    horizon: int = 24
    compute_dtype: str = "float32"
    # checkpoint chunks of the encoder's recurrence (the decoder never)
    remat_chunk: int | None = None

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got "
                f"{self.compute_dtype!r}")


def init_seq2seq(gen: torch.Generator, cfg: Seq2SeqConfig):
    """Parameter dict drawn on the CPU from ``gen``: per layer the
    encoder's then the decoder's cell init, then a Glorot projection and a
    zero bias."""
    enc, dec = [], []
    for i in range(cfg.num_layers):
        d_in = cfg.num_features if i == 0 else cfg.hidden_size
        enc.append(init_lstm_params(gen, d_in, cfg.hidden_size))
        dec.append(init_lstm_params(gen, d_in, cfg.hidden_size))
    proj = {"kernel": glorot_uniform(gen, (cfg.hidden_size, cfg.num_features)),
            "bias": torch.zeros((cfg.num_features,), dtype=torch.float32)}
    return {"encoder": enc, "decoder": dec, "proj": proj}


def seq2seq_params_to(params, device) -> dict:
    """The forecaster's parameter dict with every tensor on ``device``."""
    def layers(ls):
        return [LSTMParams(*(t.to(device) for t in layer)) for layer in ls]

    return {"encoder": layers(params["encoder"]),
            "decoder": layers(params["decoder"]),
            "proj": {k: v.to(device) for k, v in params["proj"].items()}}


def _project(proj, h: torch.Tensor) -> torch.Tensor:
    return h.to(proj["kernel"].dtype) @ proj["kernel"] + proj["bias"]


def encode(params, context: torch.Tensor, cfg: Seq2SeqConfig):
    """context [B, T, F] → the per-layer final carries ``[(h, c), ...]``."""
    carries, _ = stacked_lstm_scan(params["encoder"], context,
                                   compute_dtype=cfg.compute_dtype,
                                   remat_chunk=cfg.remat_chunk)
    return carries


def decode_teacher_forced(params, carries, decoder_inputs: torch.Tensor,
                          cfg: Seq2SeqConfig) -> torch.Tensor:
    """decoder_inputs [B, horizon, F] (the last context step, then the
    targets shifted by one) → predictions [B, horizon, F]."""
    ys = decoder_inputs
    for p, c0 in zip(params["decoder"], carries):
        _, ys = auto_lstm_scan(p, ys, c0, compute_dtype=cfg.compute_dtype)
    return _project(params["proj"], ys)


def decode_autoregressive(params, carries, first_input: torch.Tensor,
                          cfg: Seq2SeqConfig) -> torch.Tensor:
    """``horizon`` steps, each fed the previous step's projection;
    first_input [B, F] (the last observed step). Returns [B, horizon, F]."""
    fused = [fuse_params(p, compute_dtype=cfg.compute_dtype)
             for p in params["decoder"]]
    layer_carries, x = list(carries), first_input
    ys = []
    for _ in range(cfg.horizon):
        h = x
        for i, f in enumerate(fused):
            layer_carries[i], h = lstm_step(f, layer_carries[i], h)
        x = _project(params["proj"], h)
        ys.append(x)
    return torch.stack(ys, dim=1)


def seq2seq_loss(params, batch, cfg: Seq2SeqConfig):
    """batch: {"context" [B, T, F], "targets" [B, horizon, F]} (a "valid"
    key is ignored, as in JAX). The teacher-forced MSE; ``aux = {"loss",
    "mae"}``. The decoder's input at step t is the previous true step (the
    context's last step at t = 0)."""
    context, targets = batch["context"], batch["targets"]
    carries = encode(params, context, cfg)
    dec_in = torch.cat([context[:, -1:], targets[:, :-1]], dim=1)
    preds = decode_teacher_forced(params, carries, dec_in, cfg)
    loss = torch.mean((preds - targets) ** 2)
    return loss, {"loss": loss, "mae": torch.mean(torch.abs(preds - targets))}


def forecast(params, context: torch.Tensor, cfg: Seq2SeqConfig) -> torch.Tensor:
    """Free-running forecast: context [B, T, F] → [B, horizon, F]."""
    carries = encode(params, context, cfg)
    return decode_autoregressive(params, carries, context[:, -1], cfg)
