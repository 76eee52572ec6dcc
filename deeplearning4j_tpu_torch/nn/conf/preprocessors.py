"""Input preprocessors between layer families (the JAX package's
``nn/conf/preprocessors.py``; so far the feed-forward / recurrent pair and
``auto_preprocessor``, which ``ListBuilder.build`` calls). RNN tensors are
``[B, T, F]``, as in the JAX package. The CNN preprocessors are not ported
yet: ``auto_preprocessor`` raises where it would insert one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType


@dataclass
class InputPreProcessor:
    def transform(self, x: torch.Tensor, in_type: InputType) -> torch.Tensor:
        raise NotImplementedError

    def infer_output_type(self, in_type: InputType) -> InputType:
        raise NotImplementedError

    def transform_mask(self, mask: Optional[torch.Tensor],
                       in_type: InputType):
        return mask


@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B, T, F] kept as-is; downstream feed-forward layers broadcast over
    T (numerically the same as flattening to [B*T, F] for dense ops)."""

    def transform(self, x, in_type):
        return x

    def infer_output_type(self, in_type):
        return InputType.feed_forward(in_type.size)


@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    def transform(self, x, in_type):
        return x  # [B, T, F] already, or [B, F] broadcast by the layer

    def infer_output_type(self, in_type):
        return InputType.recurrent(in_type.flat_size())


def auto_preprocessor(current: InputType, expected_kind: str
                      ) -> Optional[InputPreProcessor]:
    """The preprocessor bridging ``current`` to a layer expecting
    ``expected_kind`` ('ff' | 'cnn' | 'rnn' | 'any'), or None."""
    kind = "ff" if current.kind == "cnnflat" else current.kind
    if expected_kind in ("any", kind) and not (
            current.kind == "cnnflat" and expected_kind == "cnn"):
        return None
    if kind == "rnn" and expected_kind == "ff":
        return RnnToFeedForwardPreProcessor()
    if kind == "ff" and expected_kind == "rnn":
        return FeedForwardToRnnPreProcessor()
    if (kind, expected_kind) in (("cnn", "ff"), ("ff", "cnn"),
                                 ("cnn", "rnn")):
        raise NotImplementedError(
            f"a {current.kind} -> {expected_kind} input preprocessor is a "
            "CNN one, which the port does not have yet")
    raise ValueError(f"No preprocessor from {current.kind} to "
                     f"{expected_kind}")
