"""Serving plane of the port: state cache, engine, batcher, servers."""

from .batcher import Batcher, QueueFullError, Request
from .engine import GREEDY, PAD_TOKEN, DecodeWindow, SamplingParams, ServeEngine
from .server import InprocessClient, ServeServer, make_http_server
from .state_cache import (PREFIX_SID_NAMESPACE, CacheFullError, DetachedState,
                          PrefixCache, SessionTiers, StateCache,
                          session_file_path)

__all__ = [
    "Batcher", "CacheFullError", "DecodeWindow", "DetachedState", "GREEDY",
    "InprocessClient", "PAD_TOKEN", "PREFIX_SID_NAMESPACE", "PrefixCache",
    "QueueFullError", "Request", "SamplingParams", "ServeEngine",
    "ServeServer", "SessionTiers", "StateCache", "make_http_server",
    "session_file_path",
]
