"""LM batching: a token stream → contiguous [B, T] windows (host, numpy).

Port of the LM part of ``lstm_tensorspark_tpu/data/batching.py``. The
stream is split into ``batch_size`` parallel row streams so window t's
final recurrent state can seed window t+1 (stateful truncated BPTT).
"""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np


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
