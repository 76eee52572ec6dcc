"""Resilience (the JAX package's ``resilience/``): the crash-safe commit
and checksums of ``atomic`` (``CheckpointError``), the serving errors and
deadlines, the fault-injection hooks of the generation engine and of a
checkpoint's commit, and the host-side nonfinite check. The trainers'
fault tolerance, the elastic and fleet paths wait for ROADMAP A5 (part 2)
and A6."""

from deeplearning4j_tpu_torch.resilience.atomic import (  # noqa: F401
    CheckpointError,
)
from deeplearning4j_tpu_torch.resilience.faultinject import (  # noqa: F401
    Fault, FaultSchedule, KilledByFault,
)
