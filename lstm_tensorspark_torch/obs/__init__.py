"""Telemetry plane of the port: one registry of counters, gauges and
fixed-bucket histograms, served as ``GET /metrics`` (Prometheus text) and
as histogram summaries inside ``/stats``.

Recording sites take a registry (the serve engine's ``metrics``, which the
batcher, the caches, the router and the server share), defaulting to
:data:`REGISTRY`; :data:`NULL_REGISTRY` disables them with no-op
instruments:

- ``serve/batcher.py`` — queue depth and wait, scheduler iteration time,
  server-side TTFT and inter-token gaps, windows by K, prefill chunks,
  readback latency, request outcomes and deadline expiries;
- ``serve/router.py`` — sheds by class, Retry-After hints, routing;
- ``serve/state_cache.py`` — state-cache evictions and swaps, prefix-cache
  events, tier spills, fills and losses;
- ``serve/server.py`` — gauges refreshed at scrape time (slot occupancy,
  tier entries, replicas, model residency) and replay dedup.
"""

from .metrics import (
    DEFAULT_LATENCY_BUCKETS,
    NULL_REGISTRY,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    parse_exposition,
)

__all__ = [
    "Counter",
    "DEFAULT_LATENCY_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "NULL_REGISTRY",
    "REGISTRY",
    "parse_exposition",
]
