"""Capped exponential backoff with jitter: the load generator's retry
curve after a 429 shed, floored by the server's ``Retry-After`` hint.

A copy of ``lstm_tensorspark_tpu/resilience/backoff.py`` (the same curve
the JAX package's supervisor and loadgen use), so "the client retried
after X" means the same X in both packages.
"""

from __future__ import annotations

import random


def backoff_delay(base: float, attempt: int, *, cap: float = 30.0,
                  jitter: float = 0.5, rand=None) -> float:
    """Delay for ``attempt`` (1-based): exponential from ``base`` with up
    to ``+jitter`` fractional randomization, then capped (the cap bounds
    the slept delay, jitter included). ``rand`` is injectable for
    deterministic tests."""
    if base <= 0:
        return 0.0
    delay = base * (2.0 ** max(attempt - 1, 0))
    r = random.random() if rand is None else rand()
    return min(delay * (1.0 + jitter * r), cap)
