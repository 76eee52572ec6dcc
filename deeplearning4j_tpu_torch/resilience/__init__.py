"""Resilience (the JAX package's ``resilience/``): the crash-safe commit
and checksums of ``atomic`` (``CheckpointError``), the serving edge's
kit (``service``: structured errors, deadlines, circuit breakers,
admission and drain), the fault-injection hooks of the gateway, the
generation engine and a checkpoint's commit, and the host-side nonfinite
check. The trainers' fault tolerance, the elastic and fleet paths wait
for ROADMAP A5.3 and A6."""

from deeplearning4j_tpu_torch.resilience.atomic import (  # noqa: F401
    CheckpointError,
)
from deeplearning4j_tpu_torch.resilience.faultinject import (  # noqa: F401
    Fault, FaultSchedule, KilledByFault,
)
