"""Input preprocessors between layer families (the JAX package's
``nn/conf/preprocessors.py``) and ``auto_preprocessor``, which
``ListBuilder.build`` and the graph builder call where a layer's input
kind differs from what it expects. CNN tensors are NHWC ``[B, H, W, C]``
and RNN tensors ``[B, T, F]``, as in the JAX package, so a CNN flattens
in ``h, w, c`` order with c fastest: a dense layer's ``W`` copied from the
JAX net reads the same features.
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
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B, H, W, C] -> [B, H * W * C]."""

    def transform(self, x, in_type):
        return x.reshape(x.shape[0], -1)

    def infer_output_type(self, in_type):
        return InputType.feed_forward(in_type.flat_size())


@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[B, H * W * C] -> [B, H, W, C]."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def transform(self, x, in_type):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def infer_output_type(self, in_type):
        return InputType.convolutional(self.height, self.width, self.channels)


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


@dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """[B, H, W, C] -> [B, 1, H * W * C]: the whole volume is one time
    step, as in the JAX package."""

    def transform(self, x, in_type):
        return x.reshape(x.shape[0], 1, -1)

    def infer_output_type(self, in_type):
        return InputType.recurrent(in_type.flat_size(), 1)


@dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """[B, T, H * W * C] -> [B * T, H, W, C]."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def transform(self, x, in_type):
        b, t, _ = x.shape
        return x.reshape(b * t, self.height, self.width, self.channels)

    def infer_output_type(self, in_type):
        return InputType.convolutional(self.height, self.width, self.channels)


def auto_preprocessor(current: InputType, expected_kind: str
                      ) -> Optional[InputPreProcessor]:
    """The preprocessor bridging ``current`` to a layer expecting
    ``expected_kind`` ('ff' | 'cnn' | 'rnn' | 'any'), or None."""
    kind = "ff" if current.kind == "cnnflat" else current.kind
    if expected_kind in ("any", kind):
        if current.kind == "cnnflat" and expected_kind == "cnn":
            return FeedForwardToCnnPreProcessor(current.height, current.width,
                                                current.channels)
        return None
    if kind == "cnn" and expected_kind == "ff":
        return CnnToFeedForwardPreProcessor()
    if kind == "ff" and expected_kind == "cnn":
        if current.kind == "cnnflat":
            return FeedForwardToCnnPreProcessor(current.height, current.width,
                                                current.channels)
        raise ValueError(
            f"Cannot infer CNN shape from {current}; set an explicit "
            "FeedForwardToCnnPreProcessor")
    if kind == "rnn" and expected_kind == "ff":
        return RnnToFeedForwardPreProcessor()
    if kind == "ff" and expected_kind == "rnn":
        return FeedForwardToRnnPreProcessor()
    if kind == "cnn" and expected_kind == "rnn":
        return CnnToRnnPreProcessor()
    raise ValueError(f"No preprocessor from {current.kind} to "
                     f"{expected_kind}")
