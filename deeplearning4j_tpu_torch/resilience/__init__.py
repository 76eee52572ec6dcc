"""Resilience (the JAX package's ``resilience/``): the crash-safe commit
and checksums of ``atomic`` (``CheckpointError``), the serving edge's
kit (``service``: structured errors, deadlines, circuit breakers,
admission and drain), the fault-injection hooks of the gateway, the
fleet, the generation engine and a checkpoint's commit, the host-side
nonfinite check, and the lease and heartbeat half of ``elastic`` that
the serving fleet runs on. The trainers' fault tolerance and
``ElasticTrainer`` wait for ROADMAP A6."""

from deeplearning4j_tpu_torch.resilience.atomic import (  # noqa: F401
    CheckpointError, atomic_write_bytes, crc32_bytes,
)
from deeplearning4j_tpu_torch.resilience.elastic import (  # noqa: F401
    ElasticError, ElasticRestartRequired, ElasticTrainer, HostHeartbeat,
    read_heartbeat_ages,
)
from deeplearning4j_tpu_torch.resilience.faultinject import (  # noqa: F401
    Fault, FaultSchedule, KilledByFault,
)
