"""Structured metrics: stdout + JSONL file.

Port of ``lstm_tensorspark_tpu/train/metrics.py::MetricsLogger``: one
record per call, with ``t`` the seconds since the logger was made (a
monotonic clock), written as a JSON line when a path is given and printed
as ``key=value`` pairs unless ``quiet``. A context manager, so the file
closes on every exit path.
"""

from __future__ import annotations

import json
import sys
import time


class MetricsLogger:
    def __init__(self, jsonl_path: str | None = None, stream=None,
                 quiet: bool = False):
        self.jsonl_path = jsonl_path
        self.stream = stream or sys.stdout
        self.quiet = quiet
        self._fh = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.monotonic()

    def log(self, record: dict) -> None:
        record = {"t": round(time.monotonic() - self._t0, 3), **record}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if not self.quiet:
            parts = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items())
            print(parts, file=self.stream, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
