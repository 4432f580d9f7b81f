"""Serving plane of the port: state cache, engine, batcher, router,
servers and the load generator."""

from .batcher import (CLASSES, Batcher, DeadlineExceededError, QueueFullError,
                      Request, retry_after_from_p99)
from .engine import GREEDY, PAD_TOKEN, DecodeWindow, SamplingParams, ServeEngine
from .loadgen import (arrival_offsets, concurrency_sweep, run_loadgen,
                      run_longtail, run_template_mix)
from .router import Replica, Router
from .server import InprocessClient, ServeServer, make_http_server
from .state_cache import (PREFIX_SID_NAMESPACE, CacheFullError, DetachedState,
                          PrefixCache, SessionTiers, StateCache,
                          session_file_path)

__all__ = [
    "Batcher", "CLASSES", "CacheFullError", "DeadlineExceededError",
    "DecodeWindow", "DetachedState", "GREEDY", "InprocessClient",
    "PAD_TOKEN", "PREFIX_SID_NAMESPACE", "PrefixCache", "QueueFullError",
    "Replica", "Request", "Router", "SamplingParams", "ServeEngine",
    "ServeServer", "SessionTiers", "StateCache", "arrival_offsets",
    "concurrency_sweep", "make_http_server", "retry_after_from_p99",
    "run_loadgen", "run_longtail", "run_template_mix", "session_file_path",
]
