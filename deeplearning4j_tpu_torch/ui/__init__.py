"""Training UI: port of deeplearning4j_tpu/ui/ (the stats listener, the
stats storages and routers, the stdlib UIServer, the component library and
the legacy listeners)."""
from . import components
from .components import (ChartHistogram, ChartLine, ChartScatter,
                         ChartStackedArea, ChartTimeline, Component,
                         ComponentDiv, ComponentTable, ComponentText,
                         render_html)
from .legacy import (ConvolutionalIterationListener,
                     FlowIterationListener,
                     HistogramIterationListener)
from .server import UIServer
from .stats import StatsListener, StatsUpdateConfiguration
from .storage import (FileStatsStorage, InMemoryStatsStorage,
                      RemoteUIStatsStorageRouter, SqliteStatsStorage,
                      StatsStorageRouter)

__all__ = ["ChartHistogram", "ChartLine", "ChartScatter",
           "ChartStackedArea", "ConvolutionalIterationListener",
           "FlowIterationListener", "HistogramIterationListener",
           "ChartTimeline", "Component", "ComponentDiv", "ComponentTable",
           "ComponentText", "FileStatsStorage", "InMemoryStatsStorage",
           "RemoteUIStatsStorageRouter", "SqliteStatsStorage", "StatsListener",
           "StatsStorageRouter", "StatsUpdateConfiguration", "UIServer",
           "components", "render_html"]
