"""Resilience (the JAX package's ``resilience/``): the crash-safe commit
and checksums of ``atomic`` (``CheckpointError``), the divergence
sentinel, ``CheckpointManager`` and ``TrainingCursor`` (``manager``), the
``FaultTolerantTrainer`` (``trainer``: resume, retry, rollback), the
serving edge's kit (``service``: structured errors, deadlines, circuit
breakers, admission and drain), the fault-injection hooks of the
trainers, the elastic trainer's hosts, the gateway, the fleet, the
generation engine and a checkpoint's commit, and ``elastic``: the lease
and heartbeat records the serving fleet runs on and ``ElasticTrainer``,
the preemption-tolerant trainer over the data-parallel trainers."""

from deeplearning4j_tpu_torch.resilience.atomic import (  # noqa: F401
    CheckpointError, atomic_write_bytes, crc32_bytes, crc32_file,
)
from deeplearning4j_tpu_torch.resilience.elastic import (  # noqa: F401
    ElasticError, ElasticFenced, ElasticRestartRequired, ElasticTrainer,
    HostHeartbeat, read_heartbeat_ages, read_lease, request_join,
    write_lease,
)
from deeplearning4j_tpu_torch.resilience.faultinject import (  # noqa: F401
    KILL_HOST_EXIT_CODE, Fault, FaultInjected, FaultSchedule, KilledByFault,
)
from deeplearning4j_tpu_torch.resilience.manager import (  # noqa: F401
    CheckpointInfo, CheckpointManager, TrainingCursor,
)
from deeplearning4j_tpu_torch.resilience.sentinel import (  # noqa: F401
    DivergenceError, DivergenceSentinel, RollbackRequested, guard_update,
    host_nonfinite, nonfinite_flag,
)
from deeplearning4j_tpu_torch.resilience.trainer import (  # noqa: F401
    FaultTolerantTrainer,
)
