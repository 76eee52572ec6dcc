"""Early stopping over the data-parallel trainer (the JAX package's
``earlystopping/parallel_trainer.py``).

Ref: deeplearning4j-scaleout-parallelwrapper/.../EarlyStoppingParallelTrainer.java
(372 LoC — early stopping driven by a ParallelWrapper underneath; listener
plumbing to pull scores out of the worker pool). Here the "wrapper" is the
port's ``ParallelTrainer`` over ``torch.distributed`` (one process per
rank, every rank running this loop on the same global batches), so the
early-stopping loop is the single-device one with the batch step routed
through the trainer. ``shardcheck`` holds the trainer's step to the SC
rules (``analysis/shardcheck``)."""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.earlystopping.config import (
    EarlyStoppingConfiguration,
)
from deeplearning4j_tpu_torch.earlystopping.trainer import (
    EarlyStoppingTrainer,
)
from deeplearning4j_tpu_torch.parallel.mesh import MeshContext
from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer


class _ParallelNetAdapter:
    """Presents the (net, trainer) pair through the net-like surface the
    early-stopping loop drives: fit_batch routes through the trainer,
    score and state live on the underlying net."""

    def __init__(self, trainer: ParallelTrainer):
        self._trainer = trainer
        self.net = trainer.net

    def fit_batch(self, batch):
        loss = self._trainer.fit_batch(batch)
        self.net.score_value = loss
        return loss

    def __getattr__(self, name):
        return getattr(self.net, name)

    def __setattr__(self, name, value):
        if name in ("_trainer", "net"):
            object.__setattr__(self, name, value)
        else:
            setattr(self.net, name, value)


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    def __init__(self, config: EarlyStoppingConfiguration, net,
                 train_data: DataSetIterator,
                 mesh: Optional[MeshContext] = None,
                 gradient_accumulation: int = 1,
                 collect_training_stats: bool = False,
                 weight_update_sharding=None,
                 precision=None, device=None):
        trainer = ParallelTrainer(
            net, mesh, gradient_accumulation=gradient_accumulation,
            collect_training_stats=collect_training_stats,
            weight_update_sharding=weight_update_sharding,
            precision=precision, device=device)
        if hasattr(train_data, "attach"):
            # the loop iterates train_data itself, never through
            # ParallelTrainer.fit: bind a streaming pipeline's device
            # stage to the mesh here, as fit does
            train_data.attach(mesh=trainer.mesh)
        super().__init__(config, _ParallelNetAdapter(trainer), train_data)
        self.trainer = trainer

    def shardcheck(self, batch, **overrides):
        """The SC rules over a record of the underlying trainer's step
        (``analysis/shardcheck``): the early-stopping loop drives the same
        ``ParallelTrainer`` step a batch."""
        return self.trainer.shardcheck(batch, **overrides)
