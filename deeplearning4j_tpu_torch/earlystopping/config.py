"""Early stopping configuration: termination conditions, score calculators,
model savers (the JAX package's ``earlystopping/config.py``).

Ref: earlystopping/EarlyStoppingConfiguration.java + termination/ (epoch &
iteration conditions), scorecalc/DataSetLossCalculator.java, saver/
{InMemoryModelSaver, LocalFileModelSaver}.java.

In the port the in-memory saver keeps copies of the params and layer
states on the net's device and restores the best ones into the net's own
tensors in place; the file saver goes through the port's
``ModelSerializer`` and restores onto the net's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.util.serializer import ModelSerializer


# ----------------------------------------------------------- epoch conditions
class EpochTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


@dataclass
class MaxEpochsTerminationCondition(EpochTerminationCondition):
    max_epochs: int = 30

    def terminate(self, epoch, score):
        return epoch >= self.max_epochs


@dataclass
class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no score improvement
    (ref: termination/ScoreImprovementEpochTerminationCondition.java)."""
    max_epochs_without_improvement: int = 5
    min_improvement: float = 0.0

    def initialize(self):
        self._best: Optional[float] = None
        self._since = 0

    def terminate(self, epoch, score):
        if self._best is None or self._best - score > self.min_improvement:
            self._best = score
            self._since = 0
            return False
        self._since += 1
        return self._since >= self.max_epochs_without_improvement


@dataclass
class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score reaches a target
    (ref: termination/BestScoreEpochTerminationCondition.java)."""
    best_expected_score: float = 0.0
    lesser_better: bool = True  # minimizing loss

    def terminate(self, epoch, score):
        return (score <= self.best_expected_score if self.lesser_better
                else score >= self.best_expected_score)


# -------------------------------------------------------- iteration conditions
class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, score: float) -> bool:
        raise NotImplementedError


@dataclass
class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort if the score explodes past a bound
    (ref: termination/MaxScoreIterationTerminationCondition.java)."""
    max_score: float = 1e9

    def terminate(self, score):
        return score > self.max_score or score != score  # NaN guard


@dataclass
class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    max_seconds: float = 3600.0

    def initialize(self):
        self._start = time.monotonic()

    def terminate(self, score):
        return (time.monotonic() - self._start) > self.max_seconds


@dataclass
class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort on NaN/Inf scores
    (ref: termination/InvalidScoreIterationTerminationCondition.java)."""

    def terminate(self, score):
        return score != score or score in (float("inf"), float("-inf"))


# ------------------------------------------------------------ score calculator
@dataclass
class DataSetLossCalculator:
    """Model score (loss) over a held-out iterator
    (ref: scorecalc/DataSetLossCalculator.java)."""
    iterator: DataSetIterator
    average: bool = True

    def calculate_score(self, net) -> float:
        total, n = 0.0, 0
        self.iterator.reset()
        for batch in self.iterator:
            s = net.score(batch)
            b = batch.num_examples()
            total += s * b
            n += b
        return total / max(n, 1) if self.average else total


# --------------------------------------------------------------------- savers
def _copy(tree):
    """Copies of a container's params or layer states (a list of
    per-layer dicts, or a dict of them by node)."""
    if isinstance(tree, dict):
        return {k: {n: t.detach().clone() for n, t in v.items()}
                for k, v in tree.items()}
    return [{n: t.detach().clone() for n, t in v.items()} for v in tree]


def _write_back(dst, src) -> None:
    """Copy each tensor of ``src`` into the same-named one of ``dst``."""
    keys = dst.keys() if isinstance(dst, dict) else range(len(dst))
    with torch.no_grad():
        for k in keys:
            for n, t in dst[k].items():
                t.copy_(src[k][n])


class InMemoryModelSaver:
    """(ref: saver/InMemoryModelSaver.java)"""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, net, score: float):
        self._best = (_copy(net.params), _copy(net.states), score)

    def save_latest_model(self, net, score: float):
        self._latest = (_copy(net.params), _copy(net.states), score)

    def get_best_model(self, net):
        if self._best is None:
            return net
        _write_back(net.params, self._best[0])
        _write_back(net.states, self._best[1])
        return net


class LocalFileModelSaver:
    """Write bestModel.zip / latestModel.zip
    (ref: saver/LocalFileModelSaver.java)."""

    def __init__(self, directory: str):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def save_best_model(self, net, score: float):
        ModelSerializer.write_model(net, self.dir / "bestModel.zip")

    def save_latest_model(self, net, score: float):
        ModelSerializer.write_model(net, self.dir / "latestModel.zip")

    def get_best_model(self, net):
        path = self.dir / "bestModel.zip"
        if path.exists():
            # container-agnostic restore: the archive may hold either a
            # MultiLayerNetwork or a ComputationGraph
            # (EarlyStoppingGraphTrainer / LocalFileGraphSaver), onto the
            # net's device
            return ModelSerializer.restore_model(path, device=net.device)
        return net


# ---------------------------------------------------------------- config+result
@dataclass
class EarlyStoppingConfiguration:
    """(ref: earlystopping/EarlyStoppingConfiguration.java Builder)"""
    epoch_termination_conditions: List[EpochTerminationCondition] = field(
        default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = field(
        default_factory=list)
    score_calculator: Optional[DataSetLossCalculator] = None
    model_saver: object = field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclass
class EarlyStoppingResult:
    """(ref: earlystopping/EarlyStoppingResult.java)"""
    termination_reason: str
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: object
