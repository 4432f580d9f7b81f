"""Framework-free helpers of the port (host-side tracing)."""

from .tracing import Tracer, get_tracer, instant, set_tracer, span

__all__ = ["Tracer", "get_tracer", "instant", "set_tracer", "span"]
