"""Datasets staged on the device once, batches cut out of them there.

Port of the single-device part of
``lstm_tensorspark_tpu/data/device_dataset.py``:

- the LM's contiguous row streams (:func:`lm_windows`' layout: inputs
  [B, n_windows*T] and the targets shifted by one token) go to the device
  once (:func:`stage_lm_data`), and a train step slices window ``w`` out of
  them there (:func:`slice_window`). ``w`` is a device int32 scalar, not a
  Python int, so a captured CUDA graph replays the slice with whatever index
  the host copied into its input buffer: a call's whole feed is one int32;
- classification examples go to the device as fixed-shape [N, ...] arrays
  (:func:`stage_examples`) and a step gathers its rows by a device index
  tensor (:func:`take_batch`);
- the forecaster's [N, F] series goes to the device once
  (:func:`stage_series`) and a step gathers its (context, horizon)
  windows by a device tensor of window starts (:func:`slice_forecast_batch`);
- :func:`stage_stacked_batches` stacks the exact batches a host eval would
  see into one [n, ...] dict on the device, for the eval fused into a
  train call.

The window order is :func:`lm_epoch_batches`' own, so a device-fed run
takes the same windows as a host-fed one and stateful carries stay
aligned; the forecast windows' order is ``forecast_starts``'.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from .batching import lm_windows


def _put(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass(frozen=True)
class DeviceLMData:
    """The LM corpus on the device and its window geometry: ``arrays`` is
    {"streams", "shifted"}, each [B, n_windows*T] int32."""

    arrays: dict
    batch_size: int
    seq_len: int
    n_windows: int


def stage_lm_data(tokens: np.ndarray, batch_size: int, seq_len: int, *,
                  device) -> DeviceLMData:
    """Build the row streams on the host (a reshape) and copy them to
    ``device`` once."""
    streams, shifted, n_windows = lm_windows(tokens, batch_size, seq_len)
    return DeviceLMData(
        arrays={"streams": _put(streams, device),
                "shifted": _put(shifted, device)},
        batch_size=batch_size, seq_len=seq_len, n_windows=n_windows)


def slice_window(arrays: dict, w, seq_len: int) -> dict:
    """Window ``w`` → {"inputs", "targets"}, each [B, T]. ``w`` is a device
    int32 scalar (gathered, so a captured graph reads it at replay) or a
    Python int (a view)."""
    if isinstance(w, int):
        s = w * seq_len
        return {"inputs": arrays["streams"][:, s:s + seq_len],
                "targets": arrays["shifted"][:, s:s + seq_len]}
    cols = (w.to(torch.long) * seq_len
            + torch.arange(seq_len, device=w.device))
    return {"inputs": arrays["streams"].index_select(1, cols),
            "targets": arrays["shifted"].index_select(1, cols)}


def window_index_stream(data: DeviceLMData, steps_per_call: int, *,
                        start_step: int = 0):
    """The first window of each K-step call, on the host, forever: wraps
    around epochs as :func:`lm_batch_stream` does. ``start_step``
    fast-forwards to the window a resumed run would be at."""
    w = start_step % data.n_windows
    while True:
        yield np.int32(w)
        w = (w + steps_per_call) % data.n_windows


def stage_stacked_batches(batches: Iterable[dict], *, device) -> dict:
    """Stack equal-shape host batches into one dict of [n, ...] tensors on
    ``device``: the eval batches of a fused train+eval call, exactly those
    the host eval would see."""
    ev = list(batches)
    if not ev:
        raise ValueError("stage_stacked_batches: empty batch iterator")
    return {k: _put(np.stack([b[k] for b in ev]), device) for k in ev[0]}


@dataclasses.dataclass(frozen=True)
class DeviceExamples:
    """Fixed-shape example arrays on the device ([N, ...] each), batched
    there by a row gather; a call's feed is its [K, B] index array."""

    arrays: dict
    num_examples: int


def stage_examples(host_arrays: dict, *, device) -> DeviceExamples:
    n = next(iter(host_arrays.values())).shape[0]
    for k, a in host_arrays.items():
        if a.shape[0] != n:
            raise ValueError(f"leading dims differ: {k} has {a.shape[0]} "
                             f"rows, expected {n}")
    return DeviceExamples(
        arrays={k: _put(a, device) for k, a in host_arrays.items()},
        num_examples=n)


def take_batch(arrays: dict, idx: torch.Tensor) -> dict:
    """Row indices [B] (a device tensor) → the batch {key: [B, ...]}."""
    rows = idx.to(torch.long)
    return {k: a.index_select(0, rows) for k, a in arrays.items()}


@dataclasses.dataclass(frozen=True)
class DeviceSeries:
    """A [N, F] float32 series on the device (``arrays`` is {"series"}),
    its (context, horizon) windows gathered there by their starts."""

    arrays: dict
    context_len: int
    horizon: int
    num_windows: int


def stage_series(series: np.ndarray, context_len: int, horizon: int, *,
                 device) -> DeviceSeries:
    n_windows = len(series) - context_len - horizon + 1
    if n_windows < 1:
        raise ValueError(f"series length {len(series)} < context "
                         f"{context_len} + horizon {horizon}")
    return DeviceSeries(arrays={"series": _put(series.astype(np.float32),
                                               device)},
                        context_len=context_len, horizon=horizon,
                        num_windows=n_windows)


def slice_forecast_batch(arrays: dict, starts: torch.Tensor, context_len: int,
                         horizon: int) -> dict:
    """Window starts [B] (a device tensor) → {"context" [B, C, F],
    "targets" [B, horizon, F], "valid" [B]}: ``forecast_windows``' layout,
    one row gather of the series for the B·(C + horizon) steps."""
    series = arrays["series"]
    B, F = starts.shape[0], series.shape[-1]
    span = context_len + horizon
    rows = (starts.to(torch.long)[:, None]
            + torch.arange(span, device=starts.device)).reshape(-1)
    win = series.index_select(0, rows).reshape(B, span, F)
    return {"context": win[:, :context_len], "targets": win[:, context_len:],
            "valid": torch.ones((B,), dtype=torch.bool, device=series.device)}
