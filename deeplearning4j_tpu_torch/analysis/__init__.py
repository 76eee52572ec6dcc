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
- ``shardcheck``: the SC rules SC001-SC010 over a step program, here a
  record of one real step (``record_step_program``; the containers',
  the data-parallel trainers' and the serving engine's decode runner's
  ``step_program`` / ``shardcheck``), with ``check_step_program``,
  ``program_comm_bytes`` and the command line (``python -m
  deeplearning4j_tpu_torch.analysis.shardcheck --self-check``). Its
  fixtures are ``fixtures.SC_KNOWN_BAD`` / ``SC_KNOWN_GOOD``; the hooks a
  running step reports through are ``steprecord``. ``ranks`` starts its
  self-check's or contracts' gloo ranks without importing torch.

- ``torchlint``: the counterpart of the JAX package's ``jaxlint``, an
  ``ast`` lint of the port's own source (TL000-TL011): code a CUDA graph
  captures (``with torch.cuda.graph`` blocks, what they call, the
  ``torch.compile`` / ``make_graphed_callables`` targets, the seams in
  ``SEAMS``) and ``torch.autograd.Function`` subclasses.
- ``lockcheck``: the JAX package's concurrency lint (LC000-LC008), the
  port's own copy; ``source_lint`` holds the suppression grammar and the
  stale pass both lints share.
- ``fixtures``: the four fixture families of the self-checks (GC, TL,
  LC, SC).
- ``analyze``: the umbrella, ``python -m
  deeplearning4j_tpu_torch.analysis.analyze [--device cpu]``, which runs
  graphcheck, torchlint, lockcheck, shardcheck and postmortem
  (``profiling/postmortem``) side by side, each through its own command
  line, and exits 0 clean, 1 on findings, 2 when a self-check broke.

The names below load on first use, so importing the package (as the
containers do for ``memory.default_kv_page_len``) pulls in no config
module.
"""

_EXPORTS = {
    "Finding": "findings", "Severity": "findings",
    "max_severity": "findings",
    "check_multilayer": "graphcheck", "check_graph": "graphcheck",
    "validate_config": "graphcheck",
    "MemoryReport": "memory", "memory_report": "memory",
    "kv_pool_plan": "memory",
    "StepProgram": "shardcheck", "StepSnapshot": "shardcheck",
    "record_step_program": "shardcheck",
    "check_step_program": "shardcheck",
    "program_comm_bytes": "shardcheck", "net_step_program": "shardcheck",
    "param_leaf_sizes": "shardcheck",
    "SC_KNOWN_BAD": "fixtures", "SC_KNOWN_GOOD": "fixtures",
    "SC_GOOD_FOR": "fixtures", "between_windows": "shardcheck",
    "KNOWN_BAD": "fixtures", "KNOWN_GOOD": "fixtures",
    "KNOWN_GOOD_FOR": "fixtures", "TL_FIXTURES": "fixtures",
    "LC_FIXTURES": "fixtures", "capture_outcome": "fixtures",
    "SEAMS": "torchlint", "Seam": "torchlint",
    "LintContext": "source_lint", "collect_suppressions": "source_lint",
    "stale_suppression_pass": "source_lint",
    "run_layers": "analyze",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
