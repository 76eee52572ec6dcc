"""Static analysis of a config, on the CPU and before any card time (the
JAX package's ``analysis/``, the config layer of it):

- ``graphcheck``: walks a ``MultiLayerConfiguration`` /
  ``ComputationGraphConfiguration`` without building a tensor and
  returns ``Finding``s: shape inference, cycles, dangling and dead
  vertices, duplicate names, loss heads, and the mesh rules (dp
  divisibility, pp balance, MoE expert counts, ZeRO legality, elastic
  resize plans, the precision policy, the composition of axes, and,
  with ``autotune_devices=``, the autotuner's verdict); rules
  GC001-GC017. ``python -m deeplearning4j_tpu_torch.analysis.graphcheck
  model.json`` runs it on a file.
- ``memory``: ``memory_report`` (param counts, the training footprint
  with the ZeRO terms, the serving KV pool) and ``kv_pool_plan``, the
  sizing rule of the serving engine's page pool.
- ``findings``: ``Finding``, ``Severity``, ``max_severity``.

The JAX package's ``jaxlint`` and ``shardcheck`` analyse JAX source and
compiled XLA programs and have no counterpart here. The names below load
on first use, so importing the package (as the containers do for
``memory.default_kv_page_len``) pulls in no config module.
"""

_EXPORTS = {
    "Finding": "findings", "Severity": "findings",
    "max_severity": "findings",
    "check_multilayer": "graphcheck", "check_graph": "graphcheck",
    "validate_config": "graphcheck",
    "MemoryReport": "memory", "memory_report": "memory",
    "kv_pool_plan": "memory",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
