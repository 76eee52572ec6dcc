"""The pluggable training-strategy SPI (the JAX package's
``parallel/strategy.py``; ref: spark/dl4j-spark/.../api/TrainingMaster.java,
TrainingHook.java).

The registry maps strategy names onto the trainers:

- ``"allreduce"``       -> ``ParallelTrainer``: synchronous gradient
  all-reduce (the updater state stays replicated and consistent);
- ``"param_averaging"`` -> ``ParallelWrapper``: the reference's
  average-every-k-iterations semantics;
- ``"delayed_sync"``    -> ``DelayedSyncTrainer``: local accumulation with
  one param-sized all-reduce every ``sync_frequency`` steps;
- ``"pipeline"``        -> pipeline parallelism, not ported (ROADMAP
  A6.2).

``create_trainer(strategy, net, ...)`` is the factory; ``hooks`` wrap the
trainer's ``fit_batch`` in ``TrainingHook`` pre/post calls. A trainer
built without a mesh trains on the card (``device=None``; it raises
without one) unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.parallel.mesh import MeshContext

TRAINING_STRATEGIES: Dict[str, Callable] = {}


def register_strategy(name: str):
    def deco(factory: Callable) -> Callable:
        TRAINING_STRATEGIES[name.lower()] = factory
        return factory
    return deco


class TrainingHook:
    """Pre/post-update hook (ref: api/TrainingHook.java — preUpdate /
    postUpdate around each worker fit)."""

    def pre_update(self, batch, trainer) -> None:
        pass

    def post_update(self, batch, trainer) -> None:
        pass


class _HookedTrainer:
    """Wraps any trainer's fit_batch with TrainingHook dispatch."""

    def __init__(self, trainer, hooks: List[TrainingHook]):
        self._trainer = trainer
        self._hooks = hooks

    def __getattr__(self, name):
        return getattr(self._trainer, name)

    def fit_batch(self, batch):
        for h in self._hooks:
            h.pre_update(batch, self._trainer)
        out = self._trainer.fit_batch(batch)
        for h in self._hooks:
            h.post_update(batch, self._trainer)
        return out


@register_strategy("allreduce")
def _allreduce(net, mesh: Optional[MeshContext] = None, **kw):
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer
    return ParallelTrainer(net, mesh, **kw)


@register_strategy("param_averaging")
def _param_averaging(net, mesh: Optional[MeshContext] = None, **kw):
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    return ParallelWrapper(net, mesh=mesh, **kw)


@register_strategy("pipeline")
def _pipeline(net, mesh: Optional[MeshContext] = None, **kw):
    raise NotImplementedError(
        "pipeline parallelism (parallel/pipeline.py) is not ported yet "
        "(ROADMAP A6.2)")


@register_strategy("delayed_sync")
def _delayed_sync(net, mesh: Optional[MeshContext] = None, **kw):
    from deeplearning4j_tpu_torch.parallel.delayed import DelayedSyncTrainer
    return DelayedSyncTrainer(net, mesh=mesh, **kw)


def create_trainer(strategy: str, net, mesh: Optional[MeshContext] = None,
                   hooks: Optional[List[TrainingHook]] = None, **kw):
    """Factory over the strategy registry (ref: TrainingMaster SPI)."""
    key = strategy.lower()
    if key not in TRAINING_STRATEGIES:
        raise ValueError(f"Unknown training strategy {strategy!r}; "
                         f"available: {sorted(TRAINING_STRATEGIES)}")
    trainer = TRAINING_STRATEGIES[key](net, mesh, **kw)
    if hooks:
        return _HookedTrainer(trainer, list(hooks))
    return trainer
