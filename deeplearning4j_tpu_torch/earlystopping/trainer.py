"""Early stopping trainer (the JAX package's ``earlystopping/trainer.py``).

Ref: earlystopping/trainer/EarlyStoppingTrainer.java:34 — epoch loop with
per-iteration abort conditions, periodic held-out scoring, best-model
checkpointing, and a typed result.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.earlystopping.config import (
    EarlyStoppingConfiguration, EarlyStoppingResult,
)
from deeplearning4j_tpu_torch.optimize.training_stats import maybe_phase


class EarlyStoppingTrainer:
    def __init__(self, config: EarlyStoppingConfiguration, net,
                 train_data: DataSetIterator, listener=None):
        self.config = config
        self.net = net
        self.train_data = train_data
        self.listener = listener  # EarlyStoppingListener or None

    def set_listener(self, listener) -> None:
        """(ref: IEarlyStoppingTrainer.setListener)"""
        self.listener = listener

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        net = self.net
        if self.listener is not None:
            self.listener.on_start(cfg, net)
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        score_vs_epoch = {}
        best_score: Optional[float] = None
        best_epoch = -1
        epoch = 0
        reason, details = "MaxEpochs", ""
        while True:
            self.train_data.reset()
            aborted = False
            for batch in self.train_data:
                net.fit_batch(batch)
                for c in cfg.iteration_termination_conditions:
                    if c.terminate(net.score_value):
                        reason = "IterationTerminationCondition"
                        details = f"{type(c).__name__} at score {net.score_value}"
                        aborted = True
                        break
                if aborted:
                    break
            if aborted:
                break
            epoch += 1
            net.epoch_count += 1
            if epoch % cfg.evaluate_every_n_epochs == 0:
                if cfg.score_calculator is not None:
                    score = cfg.score_calculator.calculate_score(net)
                else:
                    score = net.score_value
                score_vs_epoch[epoch] = score
                # per-phase telemetry when driven by a stats-collecting
                # ParallelTrainer (checkpoint = saver/serializer time)
                stats = getattr(getattr(net, "_trainer", None),
                                "training_stats", None)
                if best_score is None or score < best_score:
                    best_score = score
                    best_epoch = epoch
                    with maybe_phase(stats, "checkpoint"):
                        cfg.model_saver.save_best_model(net, score)
                if cfg.save_last_model:
                    with maybe_phase(stats, "checkpoint"):
                        cfg.model_saver.save_latest_model(net, score)
            if self.listener is not None:
                self.listener.on_epoch(
                    epoch, score_vs_epoch.get(epoch, net.score_value),
                    cfg, net)
            stop = False
            for c in cfg.epoch_termination_conditions:
                if c.terminate(epoch, score_vs_epoch.get(epoch, net.score_value)):
                    reason = "EpochTerminationCondition"
                    details = f"{type(c).__name__} at epoch {epoch}"
                    stop = True
                    break
            if stop:
                break
        # drain lag-pending divergence flags BEFORE picking the best
        # model: a raise-policy sentinel must not let a run whose last
        # step diverged report a clean result (resilience/sentinel.py)
        sentinel = getattr(net, "_sentinel", None)
        if sentinel is not None:
            sentinel.flush()
        best_model = cfg.model_saver.get_best_model(net)
        result = EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            total_epochs=epoch,
            best_model_epoch=best_epoch,
            best_model_score=best_score if best_score is not None else float("nan"),
            score_vs_epoch=score_vs_epoch,
            best_model=best_model,
        )
        if self.listener is not None:
            self.listener.on_completion(result)
        return result


class EarlyStoppingListener:
    """Callbacks around the early-stopping loop
    (ref: listener/EarlyStoppingListener.java — onStart/onEpoch/
    onCompletion)."""

    def on_start(self, config, net) -> None:
        pass

    def on_epoch(self, epoch: int, score: float, config, net) -> None:
        pass

    def on_completion(self, result) -> None:
        pass


class EarlyStoppingGraphTrainer(EarlyStoppingTrainer):
    """Reference-named trainer for ComputationGraph models
    (ref: trainer/EarlyStoppingGraphTrainer.java). The base trainer is
    container-agnostic (fit_batch/score contract), so this is the naming
    alias the reference API promises."""
