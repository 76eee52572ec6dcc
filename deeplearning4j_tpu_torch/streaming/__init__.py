"""Streaming ingestion and serving (the JAX package's ``streaming/``).

The counterpart of ``dl4j-streaming`` (ref: dl4j-streaming/.../kafka/
{NDArrayKafkaClient,NDArrayPublisher,NDArrayConsumer}.java, the Camel
route routes/DL4jServeRouteBuilder.java, pipeline/StreamingPipeline.java).
The reference moves serialized NDArrays over Kafka topics; here the
transport is a length-prefixed npy wire format over TCP sockets, the
JAX package's byte for byte, with the same roles: publisher, consumer,
and a serve route that runs a model over each incoming batch and
publishes its predictions.
"""

from deeplearning4j_tpu_torch.streaming.ndarray_channel import (  # noqa: F401
    FRAME_CAP_BYTES,
    NDArrayConsumer,
    NDArrayPublisher,
    NDArrayServer,
    ProtocolError,
)
from deeplearning4j_tpu_torch.streaming.pipeline import (  # noqa: F401
    ServeRoute,
    StreamingPipeline,
)
