"""autotune: a cost-model-driven search for the training configuration,
validated by measured probes (the JAX package's ``autotune/``).

    from deeplearning4j_tpu_torch.autotune import autotune

    tuned = autotune(net, global_batch=32)  # the process group's ranks
    trainer = tuned.trainer(net)            # or ParallelTrainer(net,
    trainer.fit(data)                       #        tuned=tuned)

Enumeration and pruning are metadata, the ranking is the analytic cost
model (``autotune/model``), and the probes are short real steps on the
net's device over the current process group.
"""

from deeplearning4j_tpu_torch.autotune.config import ProbeRecord, TunedConfig
from deeplearning4j_tpu_torch.autotune.space import (
    Candidate, default_candidate, enumerate_space, mesh_shapes,
    serve_bucket_set,
)
from deeplearning4j_tpu_torch.autotune.tuner import (
    AutotuneError, analytic_search, autotune,
)

__all__ = [
    "autotune", "analytic_search", "AutotuneError",
    "TunedConfig", "ProbeRecord",
    "Candidate", "enumerate_space", "mesh_shapes",
    "default_candidate", "serve_bucket_set",
]
