"""Carry weights from the JAX package's nets into the port.

``params_from_jax(conf, params)`` takes a JAX ``ComputationGraph``'s params
as nested numpy dicts (node -> param name -> array, e.g.
``jax.tree.map(np.asarray, net.params)``) and returns the port's params for
the port config ``conf``, so that both nets compute the same function.
Both packages keep the same names and layouts (``W`` ``[in, out]``,
attention ``Wq/Wk/Wv`` ``[F, H*D]``), so each tensor is a copy, not a
transpose. This module imports nothing of the JAX package: it reads
arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.layers.base import BaseLayerConf


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16, unknown to torch
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def layer_params_from_jax(layer: BaseLayerConf,
                          params: Mapping) -> Dict[str, torch.Tensor]:
    """One layer's params, by its ``param_order()`` names."""
    names = layer.param_order()
    missing = [n for n in names if n not in params]
    extra = [n for n in params if n not in names]
    if missing or extra:
        raise ValueError(
            f"{type(layer).__name__} {layer.name!r}: params "
            f"{sorted(params)} do not match param_order() {names}")
    return {n: _to_tensor(params[n]) for n in names}


def params_from_jax(conf, params: Mapping
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's params (CPU tensors) for every layer node of ``conf``."""
    out = {}
    for name in conf.topological_order:
        node = conf.nodes[name]
        if node.kind == "layer":
            out[name] = layer_params_from_jax(node.layer,
                                              params.get(name, {}))
    return out
