"""Batching (host, numpy): a token stream → contiguous [B, T] LM windows,
variable-length examples → padded, length-bucketed batches, and a [N, F]
series → (context, horizon) forecast windows.

Port of the LM, classification and forecasting parts of
``lstm_tensorspark_tpu/data/batching.py``. The LM stream is split into
``batch_size`` parallel row streams so window t's final recurrent state
can seed window t+1 (stateful truncated BPTT). :func:`stacked_batches` and
:func:`index_groups` feed the K-steps-per-call train steps
(``train/multistep.py``, ``train/device_step.py``).
"""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np


def epoch_stream(epoch_fn, *, steps_per_epoch: int, start_step: int = 0):
    """Endless epochs of ``epoch_fn(epoch)`` batches; ``start_step``
    fast-forwards the epoch index (and so any per-epoch shuffle seed in
    ``epoch_fn``) and the in-epoch offset to where a resumed run is."""
    epoch, skip = divmod(start_step, steps_per_epoch) if start_step else (0, 0)
    while True:
        it = epoch_fn(epoch)
        if skip:
            it = itertools.islice(it, skip, None)
            skip = 0
        yield from it
        epoch += 1


def cap_batches(batches, n: int | None):
    """First ``n`` batches when set (the --eval-batches cost bound), else
    the full stream."""
    return itertools.islice(batches, n) if n else batches


def lm_windows(tokens: np.ndarray, batch_size: int, seq_len: int):
    """Arrange a token stream [N] into contiguous per-row streams.

    Returns ``(streams, shifted, n_windows)``: ``streams`` [B, n_windows*T]
    holds the inputs, ``shifted`` the same array offset by one token (the
    targets), so window w slices columns [w*T, (w+1)*T) of both."""
    n_windows = (len(tokens) - 1) // (batch_size * seq_len)
    if n_windows < 1:
        raise ValueError(
            f"corpus too small: {len(tokens)} tokens for B={batch_size} T={seq_len}")
    usable = n_windows * batch_size * seq_len
    streams = tokens[:usable].reshape(batch_size, n_windows * seq_len)
    # targets need one extra token per stream: shift within the stream and
    # borrow the next token for the last position
    extra = tokens[1: usable + 1].reshape(batch_size, n_windows * seq_len)
    return streams, extra, n_windows


def lm_epoch_batches(tokens: np.ndarray, batch_size: int,
                     seq_len: int) -> Iterator[dict]:
    """One epoch of contiguous LM windows: {"inputs","targets"} each [B,T]."""
    streams, shifted, n_windows = lm_windows(tokens, batch_size, seq_len)
    for w in range(n_windows):
        s = w * seq_len
        yield {
            "inputs": streams[:, s: s + seq_len],
            "targets": shifted[:, s: s + seq_len],
        }


def lm_batch_stream(tokens: np.ndarray, batch_size: int, seq_len: int, *,
                    num_epochs: int | None = None,
                    start_step: int = 0) -> Iterator[dict]:
    """Repeat epochs (forever if num_epochs is None).

    ``start_step`` fast-forwards the stream to the window a resumed run
    would be at (each optimizer step consumes one window; epochs are
    identical — no shuffle — so only the in-epoch offset matters, and
    skipped epochs still count toward ``num_epochs``)."""
    epoch, skip = 0, 0
    if start_step:
        _, _, n_windows = lm_windows(tokens, batch_size, seq_len)
        epoch, skip = divmod(start_step, n_windows)
    while num_epochs is None or epoch < num_epochs:
        it = lm_epoch_batches(tokens, batch_size, seq_len)
        if skip:
            it = itertools.islice(it, skip, None)
            skip = 0
        yield from it
        epoch += 1


def stacked_batches(batches: Iterator[dict], k: int) -> Iterator[dict]:
    """Group ``k`` consecutive batches into one dict of [k, ...] arrays,
    the host feed of a K-step call. Order is kept, so contiguous LM windows
    stay contiguous across the stack; a trailing group smaller than ``k``
    is dropped (it would need a call of another shape)."""
    group: list[dict] = []
    for b in batches:
        group.append(b)
        if len(group) == k:
            yield {key: np.stack([g[key] for g in group]) for key in group[0]}
            group = []


def index_groups(order_fn, batch_size: int, steps_per_call: int, *,
                 start_step: int = 0) -> Iterator[np.ndarray]:
    """Epochs of example-index batches packed into [K, B] int32 groups, the
    index feed of a device-data K-step call. ``order_fn(epoch)`` is that
    epoch's 1-D example order; full batches only (as the host feed), and a
    partial group carries over into the next epoch. ``start_step``
    fast-forwards the epoch (so ``order_fn``'s per-epoch seed) and skips
    the batches a resumed run has already taken."""
    epoch, group, skip = 0, [], 0
    if start_step:
        per_epoch = max(len(order_fn(0)) // batch_size, 0)
        if per_epoch:
            epoch, skip = divmod(start_step, per_epoch)
    while True:
        order = order_fn(epoch)
        for b0 in range(skip * batch_size, len(order) - batch_size + 1,
                        batch_size):
            group.append(order[b0:b0 + batch_size].astype(np.int32))
            if len(group) == steps_per_call:
                yield np.stack(group)
                group = []
        skip = 0
        epoch += 1


def example_order(lengths: list[int], *, shuffle_seed: int | None = None,
                  bucket: bool = True) -> np.ndarray:
    """The example order: a seeded shuffle, then a stable sort by length
    (length buckets)."""
    order = np.arange(len(lengths))
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed).shuffle(order)
    if bucket:
        order = order[np.argsort([lengths[i] for i in order], kind="stable")]
    return order


def forecast_starts(n_windows: int, *,
                    shuffle_seed: int | None = None) -> np.ndarray:
    """The forecast windows' start order, a seeded shuffle: shared by
    :func:`forecast_windows` and the series staged on the device."""
    starts = np.arange(0, n_windows)
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed).shuffle(starts)
    return starts


def forecast_windows(series: np.ndarray, context_len: int, horizon: int,
                     batch_size: int, *, shuffle_seed: int | None = None,
                     drop_remainder: bool = True) -> Iterator[dict]:
    """(context, horizon) windows slid over a [N, F] series, batched:
    {"context" [B, C, F] float32, "targets" [B, horizon, F] float32,
    "valid" [B] bool}. With ``drop_remainder=False`` the last short batch
    keeps its shape by repeating its final window as filler rows marked
    ``valid=False``, so metrics weight rows and count no window twice."""
    N = len(series)
    n_windows = N - context_len - horizon + 1
    if n_windows < 1:
        raise ValueError(
            f"series length {N} < context {context_len} + horizon {horizon}")
    starts = forecast_starts(n_windows, shuffle_seed=shuffle_seed)
    for b0 in range(0, len(starts), batch_size):
        idx = starts[b0:b0 + batch_size]
        valid = np.ones((batch_size,), bool)
        if len(idx) < batch_size:
            if drop_remainder:
                break
            valid[len(idx):] = False
            idx = np.concatenate(
                [idx, np.repeat(idx[-1:], batch_size - len(idx))])
        ctx = np.stack([series[i:i + context_len] for i in idx])
        tgt = np.stack([series[i + context_len:i + context_len + horizon]
                        for i in idx])
        yield {"context": ctx.astype(np.float32),
               "targets": tgt.astype(np.float32), "valid": valid}


def padded_batches(sequences: list[np.ndarray], labels: np.ndarray,
                   batch_size: int, max_len: int, *, bucket: bool = True,
                   shuffle_seed: int | None = None,
                   drop_remainder: bool = True) -> Iterator[dict]:
    """Variable-length classification batches padded to ``max_len``:
    {"tokens" [B, L] int32, "lengths" [B] int32, "labels" [B] int32,
    "valid" [B] bool}. With ``drop_remainder=False`` the last short batch
    is filled with all-zero rows marked ``valid=False`` (length 0), so
    metrics weight rows instead of counting an example twice."""
    order = example_order([len(s) for s in sequences],
                          shuffle_seed=shuffle_seed, bucket=bucket)
    for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size and drop_remainder:
            break
        toks = np.zeros((batch_size, max_len), np.int32)
        lens = np.zeros((batch_size,), np.int32)
        labs = np.zeros((batch_size,), np.int32)
        valid = np.zeros((batch_size,), bool)
        for row, i in enumerate(idx):
            seq = sequences[i][:max_len]
            toks[row, :len(seq)] = seq
            lens[row] = len(seq)
            labs[row] = labels[i]
            valid[row] = True
        yield {"tokens": toks, "lengths": lens, "labels": labs, "valid": valid}
