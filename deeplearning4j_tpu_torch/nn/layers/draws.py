"""The random draws of layerwise pretraining, one function per kind: the
VAE's reparameterization noise (``normal``), the denoising AutoEncoder's
keep-mask (``keep_mask``) and the RBM's CD-k sampling uniforms
(``uniform``). Each draws from the net's explicit ``torch.Generator`` (a
CUDA generator for a net on the card), on the device it is given.

The layers call these through the module (``draws.normal(...)``), never
by a name bound at import, so a test or a smoke run can replace one to
carry another run's draws across in the same order (the JAX package's,
or a CPU twin's): per pretraining step, a VAE's ``num_samples`` normals,
an AE's one mask, an RBM's ``k`` uniforms. Torch's generators cannot
reproduce ``jax.random``'s bits, so without such a replacement the port
is held to the draws' structure (their count, shapes and order, and two
runs from one generator state equal bit for bit), as dropout is."""

from __future__ import annotations

from typing import Sequence

import torch


def normal(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
           device) -> torch.Tensor:
    """Standard normal draws of ``shape``."""
    return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                       device=device)


def keep_mask(gen: torch.Generator, p_keep: float, shape: Sequence[int],
              device) -> torch.Tensor:
    """A bool mask of ``shape``, each element True with ``p_keep``."""
    return torch.rand(tuple(shape), generator=gen, device=device) < p_keep


def uniform(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
            device) -> torch.Tensor:
    """Uniform draws on [0, 1) of ``shape``."""
    return torch.rand(tuple(shape), generator=gen, dtype=dtype,
                      device=device)
