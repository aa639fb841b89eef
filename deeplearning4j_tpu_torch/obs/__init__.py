"""Observability: span tracing and the metrics registry. Port of
deeplearning4j_tpu/obs/ (stdlib only, as there): `registry`, `trace` and
`decompose` are copies of the reference's modules; `fleet` (the fleet
plane) comes with the decode server (ROADMAP.md queue 1 item 6).

`TRACER` is the process-wide tracer (disabled until `enable_tracing()`);
`registry.default_registry()` is the process-wide metrics surface.
"""
from __future__ import annotations

from . import registry
from .decompose import decompose, decompose_requests
from .registry import Histogram, MetricsRegistry, default_registry, fmt
from .trace import FlightRecorder, Span, TraceContext, Tracer

TRACER = Tracer(enabled=False)


def get_tracer():
    """The process-wide tracer (servers and fit loops default to it)."""
    return TRACER


def span(name, **kw):
    """Record a span on the global tracer (no-op while disabled)."""
    return TRACER.span(name, **kw)


def enable_tracing():
    """Turn the global tracer on; returns it (for .save()/.spans())."""
    return TRACER.enable()


def disable_tracing():
    return TRACER.disable()


__all__ = [
    "Tracer", "Span", "TraceContext", "FlightRecorder",
    "MetricsRegistry", "Histogram",
    "default_registry", "fmt", "registry",
    "decompose", "decompose_requests",
    "TRACER", "get_tracer", "span", "enable_tracing", "disable_tracing",
]
