"""Observability stack: stats collection, storage, and dashboard UI (the
JAX package's ``ui/``).

Role parity with the reference's deeplearning4j-ui-parent:
listener -> compact binary StatsReport (native codec, stats_codec.cc) ->
StatsStorage (in-memory / file) -> dashboard HTTP server. Ref:
deeplearning4j-ui-model/.../stats/BaseStatsListener.java:43,
deeplearning4j-core/.../api/storage/StatsStorage.java,
deeplearning4j-play/.../play/PlayUIServer.java.
"""

from deeplearning4j_tpu_torch.ui.codec import decode_report, encode_report
from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram, ChartHorizontalBar, ChartLine, ChartScatter, Component,
    ComponentDiv, ComponentTable, ComponentText, render_html,
)
from deeplearning4j_tpu_torch.ui.listeners import (
    ConvolutionalIterationListener, FlowIterationListener, tile_activations,
)
from deeplearning4j_tpu_torch.ui.server import UIServer
from deeplearning4j_tpu_torch.ui.stats import (
    StatsInitializationReport, StatsListener, StatsReport,
)
from deeplearning4j_tpu_torch.ui.storage import (
    FileStatsStorage, InMemoryStatsStorage, RemoteStatsStorageRouter,
    StatsStorage,
)

__all__ = [
    "StatsReport", "StatsInitializationReport", "StatsListener",
    "StatsStorage", "InMemoryStatsStorage", "FileStatsStorage",
    "RemoteStatsStorageRouter", "UIServer",
    "encode_report", "decode_report",
    "Component", "ComponentText", "ComponentTable", "ComponentDiv",
    "ChartLine", "ChartScatter", "ChartHistogram", "ChartHorizontalBar",
    "render_html",
    "ConvolutionalIterationListener", "FlowIterationListener",
    "tile_activations",
]
