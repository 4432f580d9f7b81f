"""Serving plane of the port: state cache, engine, batcher, servers."""

from .batcher import Batcher, QueueFullError, Request
from .engine import GREEDY, PAD_TOKEN, DecodeWindow, SamplingParams, ServeEngine
from .server import InprocessClient, ServeServer, make_http_server
from .state_cache import CacheFullError, StateCache

__all__ = [
    "Batcher", "CacheFullError", "DecodeWindow", "GREEDY", "InprocessClient",
    "PAD_TOKEN", "QueueFullError", "Request", "SamplingParams", "ServeEngine",
    "ServeServer", "StateCache", "make_http_server",
]
