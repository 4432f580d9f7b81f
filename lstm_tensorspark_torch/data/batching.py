"""Batching (host, numpy): a token stream → contiguous [B, T] LM windows,
and variable-length examples → padded, length-bucketed batches.

Port of the LM and classification parts of
``lstm_tensorspark_tpu/data/batching.py``. The LM stream is split into
``batch_size`` parallel row streams so window t's final recurrent state
can seed window t+1 (stateful truncated BPTT).
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
