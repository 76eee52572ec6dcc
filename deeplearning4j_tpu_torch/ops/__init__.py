"""Tensor ops: activations and the flash-attention kernel wrapper."""
