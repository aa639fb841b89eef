"""Legacy UI listeners — one-call training visualization.

The port's copy of deeplearning4j_tpu/ui/legacy.py: equivalents of
reference deeplearning4j-ui's pre-Play listeners
(ui/weights/HistogramIterationListener.java,
ui/weights/ConvolutionalIterationListener.java,
ui/flow/FlowIterationListener.java): each was an IterationListener that
pushed one kind of visualization to the old UI. Here each is a thin
StatsListener preset that switches on exactly the collection the legacy
listener produced and (optionally) spins up the UIServer page that renders
it — same one-liner ergonomics, modern storage/pages underneath.
"""
from __future__ import annotations

from .stats import StatsListener, StatsUpdateConfiguration
from .storage import InMemoryStatsStorage


def _ensure_storage(storage):
    return storage if storage is not None else InMemoryStatsStorage()


class HistogramIterationListener(StatsListener):
    """Weight/gradient histograms per iteration — reference
    HistogramIterationListener.java (renders at /train/histogram)."""

    def __init__(self, frequency=1, storage=None, bins=20, **kw):
        super().__init__(
            _ensure_storage(storage),
            StatsUpdateConfiguration(collect_histograms=True,
                                     histogram_bins=bins,
                                     report_frequency=frequency), **kw)


class ConvolutionalIterationListener(StatsListener):
    """Per-layer conv activation images — reference
    ConvolutionalIterationListener.java (renders at /train/activations).
    Needs the probe batch the fused step doesn't expose."""

    def __init__(self, activation_probe, frequency=1, storage=None,
                 max_channels=8, **kw):
        super().__init__(
            _ensure_storage(storage),
            StatsUpdateConfiguration(collect_activations=True,
                                     max_activation_channels=max_channels,
                                     report_frequency=frequency),
            activation_probe=activation_probe, **kw)


class FlowIterationListener(StatsListener):
    """Network-topology flow view — reference FlowIterationListener.java.
    The DAG comes from the static-info config snapshot; score/perf update
    per iteration (renders at /train/flow)."""

    def __init__(self, frequency=1, storage=None, **kw):
        super().__init__(
            _ensure_storage(storage),
            StatsUpdateConfiguration(report_frequency=frequency), **kw)
