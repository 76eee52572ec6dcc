"""Parallel training over ``torch.distributed`` (the JAX package's
``parallel/``), one process per rank.

The reference's three data-parallel tiers (SURVEY §2.3: ParallelWrapper's
threads and parameter averaging, the parameter server's push/pull, the
Spark tier's parameter averaging) map onto:

- ``ParallelTrainer`` — synchronous gradient all-reduce, with gradient
  accumulation and ZeRO-1/2 weight-update sharding;
- ``ParallelWrapper`` — the reference's average-every-k semantics;
- ``DelayedSyncTrainer`` — local accumulation, one all-reduce every k;

with ``strategy.create_trainer`` over them, ``multihost`` to join the
group (its elastic half too: ``initialize(..., elastic=True)``,
``serve_coordination``, the topology override), and ``checkpoint``'s
sharded format. ``resilience.ElasticTrainer`` runs ``ParallelTrainer``
through host losses. ``ParallelTrainer`` also trains on a mesh with a
``model`` axis (tensor parallelism: column-parallel layers, the rest of
the sharded leaves gathered on use, ``parallel/tensor.py``) and an
``sp`` axis (sequence parallelism: ring attention, ``parallel/
sequence.py``), alone or with the data axis. ``parallel/pipeline.py``
trains over a ``pp`` axis (``PipelineTrainer``, ``GraphPipelineTrainer``:
GPipe stages, one a rank, alone or with the data axis), and
``parallel/expert.py`` holds the mixture-of-experts layer, whose experts
an ``ep`` axis splits and which ``ParallelTrainer`` steps over the global
batch on the data axis.
"""

from deeplearning4j_tpu_torch.nn.updater import PrecisionPolicy  # noqa: F401
from deeplearning4j_tpu_torch.parallel import checkpoint  # noqa: F401
from deeplearning4j_tpu_torch.parallel import multihost  # noqa: F401
from deeplearning4j_tpu_torch.parallel.delayed import (  # noqa: F401
    DelayedSyncTrainer,
)
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshContext, WeightUpdateSharding,
)
from deeplearning4j_tpu_torch.parallel.trainer import (  # noqa: F401
    ParallelTrainer,
)
from deeplearning4j_tpu_torch.parallel.wrapper import (  # noqa: F401
    ParallelWrapper,
)
