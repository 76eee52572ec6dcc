"""Profiling (the JAX package's ``profiling/``): the span tracer, the
metrics registry, the flight recorder, the watchdog (its heartbeats, the
diagnostic bundle and the ``StallWatchdog`` that writes one when a
heartbeat goes stale), the compile watcher and device-memory watermark
(``watchers``), and a training step's cost with an analytic MFU against
a peak table (``cost``)."""

from deeplearning4j_tpu_torch.profiling.cost import (  # noqa: F401
    PEAK_FLOPS_PER_CHIP, analytic_mfu, peak_flops, train_step_cost,
)
from deeplearning4j_tpu_torch.profiling.watchdog import (  # noqa: F401
    StallWatchdog, assemble_bundle, beat, heartbeat_ages,
)
from deeplearning4j_tpu_torch.profiling.watchers import (  # noqa: F401
    CompileWatcher, DeviceMemoryWatermark, device_memory_stats,
)
