"""InputType: shape metadata flowing through the config DSL (the JAX
package's ``nn/conf/inputs.py``, kept as its own copy so the port imports
nothing of that package).

Shapes are per example (no batch dim); CNN activations are NHWC, as in
the JAX package.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class InputType:
    kind: str  # "ff" | "rnn" | "cnn" | "cnnflat"
    size: Optional[int] = None            # ff / rnn feature size
    timesteps: Optional[int] = None       # rnn (None = variable)
    height: Optional[int] = None          # cnn
    width: Optional[int] = None
    channels: Optional[int] = None

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="ff", size=size)

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType(kind="rnn", size=size, timesteps=timesteps)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="cnn", height=height, width=width,
                         channels=channels)

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputType":
        return InputType(kind="cnnflat", height=height, width=width,
                         channels=channels, size=height * width * channels)

    def flat_size(self) -> int:
        if self.kind in ("ff", "cnnflat", "rnn"):
            return int(self.size)
        if self.kind == "cnn":
            return int(self.height * self.width * self.channels)
        raise ValueError(self.kind)

    def example_shape(self) -> Tuple[int, ...]:
        """Per-example array shape (batch dim excluded)."""
        if self.kind in ("ff", "cnnflat"):
            return (self.flat_size(),)
        if self.kind == "rnn":
            return (self.timesteps or 1, self.size)
        if self.kind == "cnn":
            return (self.height, self.width, self.channels)
        raise ValueError(self.kind)

    def to_dict(self) -> dict:
        return {k: v for k, v in asdict(self).items() if v is not None}

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        return InputType(**d)
