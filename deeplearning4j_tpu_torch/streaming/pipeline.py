"""Streaming serve and train routes (the JAX package's
``streaming/pipeline.py``).

Ref: dl4j-streaming/.../routes/DL4jServeRouteBuilder.java (consume
feature arrays -> model.output -> publish predictions) and
pipeline/StreamingPipeline.java (a streaming feed into training).

The wire carries host numpy arrays. ``ServeRoute`` checks the model's
output for NaN/Inf where it lies (on the card for a card net) and
publishes ``.cpu().numpy()`` of it; ``StreamingPipeline`` hands the
numpy batches to ``fit_batch``, which stages them onto the net's device
as the containers do for any host batch.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.streaming.ndarray_channel import (
    NDArrayConsumer, NDArrayPublisher,
)


def _host(y) -> np.ndarray:
    """The model's output as a host numpy array (a tensor on any device
    is copied off it once)."""
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    return np.asarray(y)


#: how long the serve loop waits for a batch before it looks at its stop
#: flag again (a quiet stream is legal; a blocked recv would not see the
#: flag, and closing the socket under it does not wake it)
POLL_S = 0.25


class ServeRoute:
    """Model-serving route: consume feature batches from ``in_topic``,
    run ``model.output``, publish predictions to ``out_topic``.
    ``start()`` runs the loop in a daemon thread until ``stop()``, which
    the loop sees within ``POLL_S`` of a quiet stream."""

    def __init__(self, model, host: str, port: int,
                 in_topic: str = "features", out_topic: str = "predictions",
                 transform: Optional[Callable[[np.ndarray],
                                              np.ndarray]] = None):
        self._model = model
        # the route idles indefinitely between batches, polling its stop
        # flag every POLL_S
        self._consumer = NDArrayConsumer(host, port, in_topic,
                                         timeout=POLL_S)
        self._publisher = NDArrayPublisher(host, port, out_topic)
        self._transform = transform
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _loop(self) -> None:
        from deeplearning4j_tpu_torch.profiling.metrics import get_registry
        from deeplearning4j_tpu_torch.resilience.sentinel import (
            host_nonfinite,
        )
        while not self._stop.is_set():
            try:
                x = self._consumer.get_array()
            except TimeoutError:
                continue        # a quiet stream: look at the stop flag
            except (ConnectionError, OSError):
                return
            if self._transform is not None:
                x = self._transform(x)
            y = self._model.output(x)
            if host_nonfinite(y):
                # never publish poison downstream: the serving analog of
                # the divergence sentinel's never-land-a-NaN rule
                get_registry().counter(
                    "serving_nonfinite_outputs_total",
                    help="predictions refused because the model output "
                         "carried NaN/Inf").inc()
                continue
            self._publisher.publish(_host(y))

    def start(self) -> "ServeRoute":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-route")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # closing the sockets unblocks the loop's get_array(); the join
        # is bounded in case a model.output call is mid-flight
        self._consumer.close()
        self._publisher.close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class StreamingPipeline:
    """Training feed: consume (features, labels) array pairs from two
    topics and fit the model batch by batch (ref: StreamingPipeline.java:
    Spark streaming -> fit). ``run(n_batches)`` is synchronous and returns
    the per-batch scores as floats."""

    def __init__(self, model, host: str, port: int,
                 features_topic: str = "train.features",
                 labels_topic: str = "train.labels"):
        self._model = model
        self._fx = NDArrayConsumer(host, port, features_topic)
        self._fy = NDArrayConsumer(host, port, labels_topic)

    def run(self, n_batches: int):
        scores = []
        for _ in range(n_batches):
            x = self._fx.get_array()
            y = self._fy.get_array()
            scores.append(float(self._model.fit_batch(DataSet(x, y))))
        return scores

    def close(self) -> None:
        self._fx.close()
        self._fy.close()
