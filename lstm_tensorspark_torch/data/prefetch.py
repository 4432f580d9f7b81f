"""Prefetch: prepare and copy the next batches while the device runs the
current step.

Port of ``lstm_tensorspark_tpu/data/prefetch.py::prefetch_to_device``. A
daemon thread pulls host batches (numpy dicts: the stacking and any other
host work happen there, off the loop's thread), pins each array and copies
it to the card on a copy stream of its own, ``size`` batches ahead; the
consumer's stream waits on that batch's event before the step reads it.
On the CPU the thread only converts the arrays to tensors.

The producer takes :data:`kernels.CAPTURE_LOCK` around its pinning
and copies: allocating pinned memory while a CUDA graph is being captured
in another thread would invalidate the capture.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..kernels import CAPTURE_LOCK


def prefetch_to_device(batches: Iterator[dict], size: int = 2, *,
                       device) -> Iterator[dict]:
    """Yield the batches of ``batches`` as tensors on ``device``, ``size``
    ahead of the consumer."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(dev) if on_card else None
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()  # the consumer is gone: exit, drop the batches

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if not on_card:
            return host, None
        with CAPTURE_LOCK, torch.cuda.device(dev), \
                torch.cuda.stream(copy_stream):
            out = {k: t.pin_memory().to(dev, non_blocking=True)
                   for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def producer():
        try:
            for b in batches:
                if stop.is_set():
                    return
                q.put(put(b))
        except Exception as e:  # noqa: BLE001 — raised in the consumer
            if not stop.is_set():
                q.put(e)
            return
        q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            out, done = item
            if done is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(done)
                for t in out.values():
                    t.record_stream(cur)  # freed only after cur's use
            yield out
    finally:
        # abandoned mid-stream (the loop stops at its step budget): stop
        # the producer and drain the queue so a blocked put returns
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
