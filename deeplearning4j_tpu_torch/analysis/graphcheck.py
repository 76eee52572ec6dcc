"""graphcheck: the config-level static validator (the JAX package's
``analysis/graphcheck.py``, kept as the port's own copy).

It walks a ``MultiLayerConfiguration`` / ``ComputationGraphConfiguration``
WITHOUT building a tensor and returns a list of ``Finding``s instead of
raising on the first defect: the collectable form of the reference's
config-time checks (``InputType.getOutputType``, the preprocessor
insertion, ``MemoryReport``), with the mesh-legality rules of the
parallel layer (dp divisibility, pp stage balance, MoE expert counts,
ZeRO legality, elastic resize plans, the precision policy, the
composition of mesh axes).

Rules (stable ids, the JAX package's; severities in parentheses):

- GC001 duplicate-name    (error)   two layers/vertices share a name
- GC002 graph-cycle       (error)   the DAG contains a cycle
- GC003 dangling-ref      (error)   a node references an unknown input
- GC004 dead-vertex       (warning) a node feeds no network output
- GC005 shape-mismatch    (error)   declared n_in contradicts the
                                    inferred input size, or per-layer
                                    shape/dtype inference fails
- GC006 missing-loss-head (warning) final layer / output node has no loss
- GC007 hbm-overflow      (warning) estimated training memory exceeds
                                    the per-card budget (the H100's,
                                    ``memory.DEFAULT_HBM_BYTES``)
- GC008 dp-indivisible    (error)   batch size not divisible by the
                                    data-parallel mesh axis
- GC009 pp-imbalance      (warning) best contiguous stage partition is
                                    skewed, or more pp stages than layers
- GC010 ep-mismatch       (error)   MoE expert count not divisible by the
                                    expert-parallel mesh axis
- GC011 wus-mesh          (error)   zero1/zero2 weight-update sharding
                                    with no data-parallel axis or dp < 2,
                                    or over a model axis; (warning)
                                    pad-to-divisible flattened-leaf
                                    padding wastes > 5% of the
                                    updater-state footprint
- GC012 vertex-arity      (error)   vertex input count != n_inputs()
- GC013 input-unsharded   (warning) a dp >= 2 mesh is fed by an iterator
                                    that neither shards its sources nor
                                    places batches for the trainer
- GC014 elastic-resize    (error)   a planned post-resize dp width (a
                                    surviving width after host loss, or a
                                    grown one a scale-up would reach)
                                    cannot split the global batch, or is
                                    not a resize; (warning) the zero1
                                    padding waste at that width exceeds
                                    the GC011 threshold
- GC015 precision-policy  (error)   the policy's compute dtype is not a
                                    float dtype; (warning) half-precision
                                    compute with no fp32 loss scale
- GC016 config-mistuned   (warning) the validated configuration's
                                    analytic step time is more than 2x
                                    the autotuner's best legal config
                                    for the same model at
                                    ``autotune_devices=`` ranks (opt-in;
                                    both sides on the config-only census
                                    and ``Hardware.reference()``)
- GC017 composition-legality (error) mesh axes composed in a shape no
                                    trainer runs: pp with sp or tp, or
                                    zero1/zero2 under pp; (warning) an
                                    sp axis over a model with no
                                    ring-capable attention layer, or a
                                    pp axis deeper than the DAG's
                                    single-tensor cut points

Entry points: ``check_multilayer`` / ``check_graph`` / ``validate_config``
(dispatch), the ``validate()`` hooks of both configuration classes and
both builders (``nn/conf``), and the CLI's file mode, ``python -m
deeplearning4j_tpu_torch.analysis.graphcheck model.json [--mesh dp=8,pp=2]
[--batch-size N] [--memory]`` (exit 1 on an ERROR finding).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from deeplearning4j_tpu_torch.analysis.findings import Finding, Severity
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

#: registered rule ids -> (slug, summary), the JAX package's (GC016's
#: too, though it waits for the autotuner)
RULES: Dict[str, Tuple[str, str]] = {
    "GC001": ("duplicate-name", "two layers/vertices share a name"),
    "GC002": ("graph-cycle", "the DAG contains a cycle"),
    "GC003": ("dangling-ref", "a node references an unknown input"),
    "GC004": ("dead-vertex", "a node feeds no network output"),
    "GC005": ("shape-mismatch", "declared n_in contradicts inference, "
                                "or shape inference fails"),
    "GC006": ("missing-loss-head", "final layer/output node has no loss"),
    "GC007": ("hbm-overflow", "estimated training HBM exceeds the "
                              "per-chip budget"),
    "GC008": ("dp-indivisible", "batch size not divisible by the dp "
                                "mesh axis"),
    "GC009": ("pp-imbalance", "best contiguous stage partition skewed, "
                              "or more pp stages than layers"),
    "GC010": ("ep-mismatch", "MoE expert count not divisible by the ep "
                             "mesh axis"),
    "GC011": ("wus-mesh", "zero1/zero2 sharding on an illegal mesh, or "
                          "excessive pad-to-divisible waste"),
    "GC012": ("vertex-arity", "vertex input count != n_inputs()"),
    "GC013": ("input-unsharded", "dp >= 2 mesh fed by a non-sharded "
                                 "iterator"),
    "GC014": ("elastic-resize", "planned post-resize width (shrink or "
                                "scale-up) cannot split the batch / is "
                                "impossible"),
    "GC015": ("precision-policy", "non-float compute dtype, or half "
                                  "precision without a loss scale"),
    "GC016": ("config-mistuned", "analytic step time > 2x the "
                                 "autotuner's best legal config for "
                                 "the same model/device count"),
    "GC017": ("composition-legality", "strategy axes composed in a "
                                      "shape no trainer runs (pp with "
                                      "sp/tp/zero), sp without a "
                                      "ring-capable attention layer, "
                                      "or pp deeper than the DAG's "
                                      "single-tensor cut points"),
}

# pp stage partitions whose heaviest stage exceeds the mean by this factor
# waste the slice (the bubble amortizes, the skew does not)
PP_IMBALANCE_RATIO = 1.5


# ---------------------------------------------------------------------------
# mesh normalization
# ---------------------------------------------------------------------------

def _mesh_axes(mesh) -> Dict[str, int]:
    """Normalize a mesh spec to {axis_name: size}: a dict such as
    ``{"dp": 8, "pp": 2}``, or the port's ``parallel.mesh.MeshContext``
    (its axes ``data`` / ``model`` / ``sp`` / ``pp`` / ``ep``)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    if all(hasattr(mesh, a) for a in
           ("n_data", "n_model", "n_seq", "n_pipe", "n_expert")):
        return {"data": int(mesh.n_data), "model": int(mesh.n_model),
                "sp": int(mesh.n_seq), "pp": int(mesh.n_pipe),
                "ep": int(mesh.n_expert)}
    raise TypeError(f"Unsupported mesh spec {type(mesh).__name__}")


def _dp_size(axes: Dict[str, int]) -> Optional[int]:
    for name in ("dp", "data"):
        if name in axes:
            return axes[name]
    return None


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _layer_label(i: int, layer) -> str:
    if getattr(layer, "name", None):
        return str(layer.name)
    return f"layer[{i}]({type(layer).__name__})"


def _safe_param_count(layer) -> int:
    """Param count via abstract eval; 0 when inference is impossible
    (a GC005 finding covers that case)."""
    from deeplearning4j_tpu_torch.analysis.memory import param_count
    try:
        return param_count(layer)
    except Exception:
        return 0


def _declared_n_ins(layer, prefix: str = "n_in") -> Dict[str, int]:
    """Every declared input width on a layer, including widths nested in
    wrapper layers (TimeDistributedLayer.inner)."""
    out: Dict[str, int] = {}
    if getattr(layer, "n_in", None) is not None:
        out[prefix] = int(layer.n_in)
    inner = getattr(layer, "inner", None)
    if inner is not None and hasattr(inner, "n_in"):
        out.update(_declared_n_ins(inner, prefix="inner." + prefix))
    return out


def _n_in_conflicts(layer, in_type: InputType):
    """[(path, declared, inferred)] for every declared n_in (nested
    wrappers included) that shape inference would overwrite with a
    different value — some layers (MoE, recurrent) record the feature
    size of an rnn input, not the flat size, so the comparison runs
    set_n_in on a DEEP copy (wrapper layers forward it to a nested layer
    object a shallow copy would share; the validator must never mutate
    the user's config)."""
    import copy
    declared = _declared_n_ins(layer)
    if not declared or not layer.has_params():
        return []
    probe = copy.deepcopy(layer)
    probe.set_n_in(in_type)
    inferred = _declared_n_ins(probe)
    return [(path, declared[path], inferred[path]) for path in declared
            if path in inferred and inferred[path] != declared[path]]


def _walk_multilayer_shapes(conf, findings: List[Finding]
                            ) -> List[Optional[InputType]]:
    """Infer each layer's OUTPUT type, collecting findings instead of
    raising. Returns one entry per layer (None once inference is lost)."""
    from deeplearning4j_tpu_torch.nn.conf.builder import expected_input_kind
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import auto_preprocessor

    out_types: List[Optional[InputType]] = []
    cur: Optional[InputType] = conf.input_type
    for i, layer in enumerate(conf.layers):
        label = _layer_label(i, layer)
        if cur is None and layer.has_params():
            if layer.n_in is None:
                findings.append(Finding(
                    "GC005", Severity.ERROR, label,
                    "n_in is not set and the configuration has no "
                    "input_type to infer it from",
                    "call set_input_type(...) on the builder or set n_in "
                    "explicitly"))
                out_types.append(None)
                continue
            # resume inference from the declared width
            cur = InputType.feed_forward(layer.n_in)
        if cur is not None:
            pre = conf.preprocessors.get(i)
            if pre is None:
                try:
                    pre = auto_preprocessor(cur, expected_input_kind(layer))
                except ValueError as e:
                    findings.append(Finding(
                        "GC005", Severity.ERROR, label, str(e),
                        "insert an explicit InputPreProcessor for this "
                        "layer"))
                    cur = None
            if pre is not None and cur is not None:
                cur = pre.infer_output_type(cur)
        if cur is not None:
            try:
                conflicts = _n_in_conflicts(layer, cur)
            except Exception:
                conflicts = []  # inference failure reported just below
            for path, declared, want in conflicts:
                findings.append(Finding(
                    "GC005", Severity.ERROR, label,
                    f"declared {path}={declared} but the previous layer "
                    f"produces {want} features ({cur})",
                    f"set {path}={want} or fix the upstream layer's "
                    "n_out"))
        if cur is None:
            out_types.append(None)
            continue
        try:
            import copy  # deep probe: never mutate the user's conf
            probe = copy.deepcopy(layer)
            probe.set_n_in(cur)
            cur = probe.infer_output_type(cur)
            out_types.append(cur)
        except Exception as e:
            findings.append(Finding(
                "GC005", Severity.ERROR, label,
                f"shape inference failed: {e}",
                "check kernel/stride/padding against the incoming "
                "activation shape"))
            cur = None
            out_types.append(None)
    return out_types


# ---------------------------------------------------------------------------
# mesh-legality checks (shared by both config kinds)
# ---------------------------------------------------------------------------

#: flattened-leaf padding above this fraction of the updater state is a
#: GC011 warning (tiny odd-sized leaves over a wide dp axis)
ZERO1_PADDING_WASTE = 0.05


def _wus_mode(weight_update_sharding) -> str:
    """Normalize a weight_update_sharding spec (None / str /
    parallel.mesh.WeightUpdateSharding) to its mode string without
    importing the parallel layer."""
    if weight_update_sharding is None:
        return "off"
    return str(getattr(weight_update_sharding, "mode",
                       weight_update_sharding)).lower()


#: weight-update-sharding modes that lay state out as (dp, chunk)
#: shards (``analysis/memory`` reads it); keep in sync with
#: ``parallel.mesh.WeightUpdateSharding``, the runtime's modes
SHARDED_WUS_MODES = ("zero1", "zero2")

#: compute dtypes whose mantissa/exponent lose information vs fp32 —
#: the GC015 loss-scale warning territory
HALF_PRECISION_DTYPES = ("bfloat16", "bf16", "float16", "fp16", "half")

#: dtype names GC015 accepts as a float compute/params dtype
FLOAT_DTYPES = ("float64", "fp64", "double", "float32", "fp32", "float",
                ) + HALF_PRECISION_DTYPES


def _precision_fields(precision):
    """Normalize a precision spec (None / preset str / dtype str /
    nn.updater.PrecisionPolicy / dict) to (compute_dtype, loss_scale)
    WITHOUT importing the nn layer. Mirrors
    ``PrecisionPolicy.parse``'s presets."""
    if precision is None:
        return None, None
    if isinstance(precision, dict):
        return (str(precision.get("compute_dtype", "float32")).lower(),
                precision.get("loss_scale"))
    compute = getattr(precision, "compute_dtype", None)
    if compute is not None:
        return str(compute).lower(), getattr(precision, "loss_scale", None)
    key = str(precision).lower()
    presets = {"fp32": "float32", "float32": "float32",
               "bf16": "bfloat16", "bfloat16": "bfloat16",
               "fp16": "float16", "float16": "float16"}
    return presets.get(key, key), None


def _check_precision(findings: List[Finding], precision,
                     loss_scale=None) -> None:
    """GC015: precision-policy legality. ``precision`` is whatever the
    config/trainer carries (preset string, PrecisionPolicy, dict);
    ``loss_scale`` overrides the spec's own when the config stores the
    two knobs separately (TrainingConfig.precision/.loss_scale)."""
    compute, spec_scale = _precision_fields(precision)
    if compute is None or compute in ("fp32", "float32"):
        return
    scale = loss_scale if loss_scale is not None else spec_scale
    if compute not in FLOAT_DTYPES:
        findings.append(Finding(
            "GC015", Severity.ERROR, f"compute={compute}",
            f"precision policy names {compute!r} as the compute dtype, "
            "which is not a float dtype — the step-boundary casts would "
            "reject it on the first step",
            "use 'bf16'/'fp16' (half compute, fp32 masters) or 'fp32'"))
        return
    if compute in HALF_PRECISION_DTYPES and scale is None:
        findings.append(Finding(
            "GC015", Severity.WARNING, f"compute={compute}",
            f"half-precision compute ({compute}) with no fp32 loss "
            "scale configured — gradients that underflow in the half "
            "backward are silently zero (bf16 keeps fp32's exponent "
            "range, so this is usually benign there; fp16 is not)",
            "set loss_scale (builder: .precision('bf16', "
            "loss_scale=...)) or accept the unscaled backward"))


def _zero1_pad_waste(all_layers: List[Tuple[str, object]],
                     width: int) -> Optional[float]:
    """Fraction of the zero1-sharded updater state that is
    pad-to-divisible filler at a ``width``-way data axis (each flattened
    leaf rounds up to a multiple of ``width``). None when no param
    shapes could be inferred."""
    from math import prod

    from deeplearning4j_tpu_torch.analysis.memory import param_shapes
    sizes: List[int] = []
    for label, layer in all_layers:
        try:
            shapes = param_shapes(layer)
        except Exception:
            continue  # inference failure already reported as GC005
        sizes.extend(int(prod(s)) if s else 1 for s in shapes.values())
    total = sum(sizes)
    if total <= 0:
        return None
    padded = sum(-(-s // width) * width for s in sizes)
    return (padded - total) / total


def _check_zero1(findings: List[Finding],
                 all_layers: List[Tuple[str, object]],
                 axes: Dict[str, int],
                 weight_update_sharding) -> None:
    """GC011: zero1/zero2 weight-update sharding legality — needs
    dp >= 2, and pad-to-divisible flattened leaves should not waste a
    meaningful fraction of the sharded updater state (both modes share
    the flattened ``(dp, chunk)`` layout, so one rule covers them)."""
    mode = _wus_mode(weight_update_sharding)
    if mode not in SHARDED_WUS_MODES:
        return
    dp = _dp_size(axes)
    if not dp or dp < 2:
        findings.append(Finding(
            "GC011", Severity.ERROR,
            f"dp={dp if dp else '<none>'}",
            f"weight_update_sharding={mode} needs a data-parallel axis "
            "of at least 2 — with a single replica there is no shard to "
            "keep and the trainers reject the config at construction",
            "grow the dp axis to >= 2 or drop to "
            "weight_update_sharding='off'"))
        return
    tp = axes.get("model") or axes.get("tp")
    if tp and tp > 1:
        findings.append(Finding(
            "GC011", Severity.ERROR, f"model={tp}",
            f"weight_update_sharding={mode} composes with pure data "
            "parallelism only — this mesh tensor-shards params over "
            f"'model' ({tp} ways), whose updater state is already "
            "distributed; the trainers reject the combination at "
            "construction",
            "drop the model axis or use weight_update_sharding='off'"))
        return
    waste = _zero1_pad_waste(all_layers, dp)
    if waste is not None and waste > ZERO1_PADDING_WASTE:
        findings.append(Finding(
            "GC011", Severity.WARNING, f"dp={dp}",
            f"{mode} flattened-leaf padding wastes {waste:.0%} of the "
            f"updater state (pad-to-divisible filler over the {dp}-way "
            "axis)",
            "shrink the dp axis, widen the model's small layers, or "
            "accept the overhead (it is per-leaf <= dp-1 elements)"))


def _check_mesh(findings: List[Finding], body_layers: List[Tuple[str, object]],
                mesh, batch_size: Optional[int],
                counts: Optional[List[int]] = None) -> None:
    """dp divisibility, pp stage balance, MoE expert counts.
    ``body_layers``: (label, layer) for every non-head layer, in order;
    ``counts``: their param counts when the caller already has them (one
    MemoryReport pass), else abstract-evaluated here."""
    axes = _mesh_axes(mesh)
    dp = _dp_size(axes)
    if dp and batch_size is not None and batch_size % dp != 0:
        findings.append(Finding(
            "GC008", Severity.ERROR, f"batch={batch_size}",
            f"batch size {batch_size} is not divisible by the "
            f"data-parallel axis (dp={dp}) — the trainer cannot cut it "
            "into equal rows and rejects the batch",
            f"use a batch size that is a multiple of {dp}"))
    pp = axes.get("pp")
    if pp and pp > 1 and body_layers:
        if counts is None:
            counts = [_safe_param_count(l) for _, l in body_layers]
        if pp > len(body_layers):
            findings.append(Finding(
                "GC009", Severity.WARNING, f"pp={pp}",
                f"{pp} pipeline stages over {len(body_layers)} body "
                "layers — trailing stages are identity pass-throughs "
                "that only add bubble ticks",
                "shrink the pp axis or deepen the model"))
        else:
            total = sum(counts)
            heaviest = _optimal_max_stage(counts, pp)
            mean = total / pp
            if mean > 0 and heaviest / mean > PP_IMBALANCE_RATIO:
                findings.append(Finding(
                    "GC009", Severity.WARNING, f"pp={pp}",
                    f"best contiguous stage partition is unbalanced: the "
                    f"heaviest stage holds {heaviest:,} of {total:,} "
                    f"params ({heaviest / max(total, 1):.0%}, vs "
                    f"{1 / pp:.0%} ideal); the other stages idle behind "
                    "it every tick",
                    "split the dominant layer, move width into other "
                    "layers, or reduce the pp axis"))
    ep = axes.get("ep")
    if ep and ep > 1:
        for label, layer in body_layers:
            n_experts = getattr(layer, "n_experts", None)
            if n_experts is not None and n_experts % ep != 0:
                findings.append(Finding(
                    "GC010", Severity.ERROR, label,
                    f"n_experts={n_experts} is not divisible by the "
                    f"expert-parallel axis (ep={ep}) — the stacked expert "
                    "weights cannot shard evenly",
                    f"use a multiple of {ep} experts or resize the ep "
                    "axis"))


def graph_cut_points(conf, order: Optional[List[str]] = None
                     ) -> List[Tuple[int, str]]:
    """Valid single-tensor pipeline stage boundaries of a DAG: positions
    ``p`` in the topological order where exactly ONE node's activation
    crosses from the prefix ``topo[:p]`` to the suffix, the single tensor
    a pipeline stage hands the next. Returns [(p, crossing_node_name)].
    A residual/skip connection spanning a candidate boundary (e.g. a
    transformer block's residual stream around its attention sublayer)
    disqualifies it: two tensors would cross. An output node counts as
    crossing to the end, so no cut strands a head's input. The one
    implementation: ``parallel/pipeline.GraphPipelineTrainer`` cuts its
    stages at these points, and GC017 counts them."""
    topo = list(order if order is not None
                else conf.topological_order or conf.nodes)
    consumers: Dict[str, List[str]] = {n: [] for n in topo}
    for n in topo:
        for i in conf.nodes[n].inputs:
            if i in consumers:   # dangling references are GC003's
                consumers[i].append(n)
    out_set = set(conf.network_outputs)
    cuts: List[Tuple[int, str]] = []
    prefix: set = set()
    crossing: set = set()
    for p, n in enumerate(topo):
        prefix.add(n)
        crossing.add(n)
        crossing = {m for m in crossing
                    if m in out_set
                    or any(c not in prefix for c in consumers[m])}
        if len(crossing) == 1:
            cuts.append((p + 1, next(iter(crossing))))
    return cuts


def _graph_single_tensor_cuts(conf, order: List[str]) -> int:
    """Count the INTERIOR body-boundary cut points GC017's pp-depth
    warning compares against — the same filtering
    ``GraphPipelineTrainer._partition`` applies to
    :func:`graph_cut_points` (cuts must land strictly inside the
    non-input, non-head body)."""
    nodes = conf.nodes
    out_set = set(conf.network_outputs)
    body = [n for n in order
            if nodes[n].kind != "input" and n not in out_set]
    body_set = set(body)
    topo_to_bidx: Dict[int, int] = {}
    b = 0
    for p, name in enumerate(order):
        topo_to_bidx[p + 1] = b + (1 if name in body_set else 0)
        if name in body_set:
            b += 1
    cut_bidx: set = set()
    for p, crossing in graph_cut_points(conf, order):
        if crossing not in body_set:
            continue
        bidx = topo_to_bidx[p]
        if 0 < bidx < len(body):
            cut_bidx.add(bidx)
    return len(cut_bidx)


def _check_composition(findings: List[Finding],
                       body_layers: List[Tuple[str, object]],
                       axes: Dict[str, int],
                       weight_update_sharding,
                       conf=None, order: Optional[List[str]] = None
                       ) -> None:
    """GC017: composition legality of the strategy cross-product (the
    rule the GPT decoder LM flushed out). Some mesh-axis
    combinations are UNREACHABLE: ``ParallelTrainer`` composes
    dp x tp x sp (one SPMD step) and the pipeline trainers compose
    dp x pp (the GPipe ring), but no trainer runs pp with sp or tp, and
    the pipeline trainers apply the replicated weight update only — a
    zero1/zero2 claim under pp would silently not shard. And some
    compositions are legal but buy nothing: an sp axis over a model
    with no ring-capable attention layer splits NOTHING (the autotune
    cost model ranks those honestly; this is the config-time warning),
    and a pp axis deeper than the DAG's single-tensor cut points forces
    identity stages — on a transformer that means the requested stage
    boundaries would have to split a block's residual stream, which the
    ring cannot carry."""
    sp = axes.get("sp") or 1
    pp = axes.get("pp") or 1
    tp = axes.get("model") or axes.get("tp") or 1
    wus = _wus_mode(weight_update_sharding)
    if pp > 1 and sp > 1:
        findings.append(Finding(
            "GC017", Severity.ERROR, f"pp={pp},sp={sp}",
            "no trainer composes pipeline parallelism with ring-"
            "attention sequence parallelism — ParallelTrainer runs "
            "dp x tp x sp, the pipeline trainers run dp x pp; a mesh "
            "with both axes is unreachable",
            "drop one axis (put the chips on dp), or stage the model "
            "with pp and keep sequences whole per stage"))
    if pp > 1 and tp > 1:
        findings.append(Finding(
            "GC017", Severity.ERROR, f"pp={pp},tp={tp}",
            "no trainer composes pipeline parallelism with tensor "
            "parallelism — the pipeline trainers pack stage params "
            "into flat ring buffers, which cannot carry a "
            "'model'-sharded kernel",
            "drop one axis, or shard kernels with tp under "
            "ParallelTrainer at pp=1"))
    if pp > 1 and wus in SHARDED_WUS_MODES:
        findings.append(Finding(
            "GC017", Severity.ERROR, f"pp={pp},wus={wus}",
            f"weight_update_sharding={wus!r} under pipeline "
            "parallelism: the pipeline trainers apply the REPLICATED "
            "update (compute_updates) — the sharded layout would "
            "silently never form, paying zero1/zero2's bookkeeping "
            "for none of its memory",
            "train zero1/zero2 on a dp(/sp) mesh via ParallelTrainer, "
            "or run the pipeline with weight_update_sharding='off'"))
    if sp > 1 and body_layers:
        ring_capable = [
            lbl for lbl, l in body_layers
            if "Attention" in type(l).__name__
            and getattr(l, "sequence_parallel", True)]
        if not ring_capable:
            findings.append(Finding(
                "GC017", Severity.WARNING, f"sp={sp}",
                f"an sp={sp} sequence-parallel axis over a model with "
                "no ring-capable attention layer: nothing rings, the "
                "sp chips idle through every step (the autotune cost "
                "model ranks such shapes with sp_effective=1 for the "
                "same reason)",
                "add a SelfAttentionLayer (sequence_parallel=True) or "
                "put the chips on the data axis"))
    if (pp > 1 and conf is not None and order is not None
            and hasattr(conf, "nodes")):
        cuts = _graph_single_tensor_cuts(conf, order)
        if cuts + 1 < pp:
            findings.append(Finding(
                "GC017", Severity.WARNING, f"pp={pp}",
                f"the DAG has only {cuts} single-tensor cut point(s) "
                f"— {pp} pipeline stages would need {pp - 1}; every "
                "other requested boundary lands inside a residual/"
                "skip region (two tensors would cross the ring), so "
                f"{pp - 1 - cuts} stage(s) degrade to identity "
                "pass-throughs that only add bubble ticks",
                f"use pp<={cuts + 1}, or restructure the graph so "
                "more block boundaries carry a single tensor"))


def _check_input(findings: List[Finding], axes: Dict[str, int],
                 input_iterator) -> None:
    """GC013: a dp >= 2 mesh fed by a non-sharded iterator. Duck-typed,
    so the validator imports no dataset or parallel module: an iterator
    is pipeline-shaped when it exposes ``attach`` (a trainer binds its
    device stage to the mesh at fit time) or reports ``places_sharded``;
    any other hands every rank the global batch, which the trainer cuts
    to the rank's rows after the host has loaded and copied all of
    them."""
    if input_iterator is None:
        return
    dp = _dp_size(axes)
    if not dp or dp < 2:
        return
    if getattr(input_iterator, "places_sharded", False) \
            or hasattr(input_iterator, "attach"):
        return
    findings.append(Finding(
        "GC013", Severity.WARNING, type(input_iterator).__name__,
        f"a dp={dp} mesh is fed by a non-sharded iterator: every rank "
        "loads and copies the whole global batch to its card, and the "
        "step keeps 1/dp of it — host work and a copy per step at the "
        "batch sizes where input is the bottleneck",
        "feed training through datasets/pipeline.StreamingInputPipeline "
        "(multihost.input_pipeline: each data rank reads a disjoint shard "
        "of the sources, and each batch lands on its card as the rank's "
        "rows, which the trainer does not cut again)"))


def _check_elastic(findings: List[Finding],
                   all_layers: List[Tuple[str, object]],
                   axes: Dict[str, int], batch_size: Optional[int],
                   weight_update_sharding,
                   elastic_resize_widths) -> None:
    """GC014: post-resize mesh legality. ``elastic_resize_widths`` lists
    the dp widths an elastic resize could leave: SURVIVING widths after
    host loss (e.g. [2, 1] for a 4-host fleet planning for up to 3
    preemptions) and, since scale-up admission exists,
    GROWN widths a rejoining replacement host would reach (e.g. 8 for
    a dp=4 fleet that may be topped back up). Each width must divide
    the global batch — ``ElasticTrainer`` splits the SAME global batch
    among the post-resize world, so an indivisible width turns a
    survivable resize into a hard ``ElasticError`` at resume — and
    under zero1/zero2 the pad-to-divisible waste is re-evaluated at
    the new width (the GC011 economics change with the axis size)."""
    if not elastic_resize_widths:
        return
    dp = _dp_size(axes)
    zero1 = _wus_mode(weight_update_sharding) in SHARDED_WUS_MODES
    for w in elastic_resize_widths:
        w = int(w)
        if w < 1 or (dp and w == dp):
            findings.append(Finding(
                "GC014", Severity.ERROR, f"resize dp={w}",
                f"{w} is not a possible post-resize width of a dp="
                f"{dp if dp else '<none>'} mesh — a resize shrinks "
                "(hosts lost) or grows (replacements admitted) the data "
                "axis; planning the current width is a no-op entry that "
                "usually means a typo in the plan",
                f"plan widths in [1, {dp - 1 if dp else '?'}] for "
                f"shrink or > {dp if dp else '?'} for scale-up"))
            continue
        if batch_size is not None and batch_size % w != 0:
            findings.append(Finding(
                "GC014", Severity.ERROR, f"resize dp={w}",
                f"global batch {batch_size} is not divisible by planned "
                f"surviving width dp={w} — after that resize "
                "ElasticTrainer cannot split the batch and resume "
                "raises instead of continuing",
                "pick a global batch divisible by every planned "
                "surviving width (or drop that width from the plan)"))
        if zero1 and w >= 2:
            waste = _zero1_pad_waste(all_layers, w)
            if waste is not None and waste > ZERO1_PADDING_WASTE:
                findings.append(Finding(
                    "GC014", Severity.WARNING, f"resize dp={w}",
                    f"at surviving width dp={w} the zero1 flattened-leaf "
                    f"padding would waste {waste:.0%} of the updater "
                    "state (re-evaluated for the post-resize axis)",
                    "accept the transient overhead or plan a narrower "
                    "surviving width"))


#: a config predicted slower than this multiple of the best legal
#: config for the same model and rank count is GC016's "leaving speed on
#: the table" territory
MISTUNE_RATIO = 2.0


def _check_mistuned(findings: List[Finding], conf, walk,
                    axes: Dict[str, int], batch_size: Optional[int],
                    weight_update_sharding, precision,
                    autotune_devices) -> None:
    """GC016: the validated configuration's analytic step time against the
    autotuner's best legal config for the same model at
    ``autotune_devices`` ranks. Opt-in (a config alone does not know its
    fleet). Both sides use the same config-only census
    (``autotune.model.census_from_conf``) at the fixed reference constants
    (``Hardware.reference()``), so the verdict does not depend on the box
    that runs it; the best config is ``autotune.tuner.analytic_best``'s,
    the tuner's own ranking and legality."""
    if not autotune_devices or int(autotune_devices) < 2 \
            or not batch_size:
        return
    from deeplearning4j_tpu_torch.autotune import model as _am
    from deeplearning4j_tpu_torch.autotune.space import Candidate
    from deeplearning4j_tpu_torch.autotune.tuner import analytic_best
    census = _am.census_from_conf(conf, walk=walk)
    if census.param_count <= 0:
        return  # shape inference failed — GC005 already reported
    compute, _ = _precision_fields(precision)
    current = Candidate(
        dp=_dp_size(axes) or 1,
        tp=axes.get("model") or axes.get("tp") or 1,
        pp=axes.get("pp") or 1, sp=axes.get("sp") or 1,
        precision=compute or "fp32",
        weight_update_sharding=_wus_mode(weight_update_sharding))
    hw = _am.Hardware.reference()
    try:
        cur = _am.predict(census, current, batch_size, hardware=hw)
        best = analytic_best(census, int(autotune_devices), batch_size,
                             hardware=hw)
    except Exception:  # noqa: BLE001 — an advisory rule must not throw
        return
    if best is None:
        return  # no legal config at that rank count: nothing to beat
    best_cand, best_cost = best
    if best_cost["step_s"] <= 0:
        return
    ratio = cur["step_s"] / best_cost["step_s"]
    if ratio > MISTUNE_RATIO:
        findings.append(Finding(
            "GC016", Severity.WARNING, current.slug(),
            f"this configuration's analytic step time is {ratio:.1f}x "
            f"the best legal config for {autotune_devices} device(s) "
            f"({best_cand.slug()}: {best_cost['step_s']:.2e}s vs "
            f"{cur['step_s']:.2e}s per step) — speed is being left on "
            "the table",
            f"run deeplearning4j_tpu_torch.autotune.autotune() or adopt "
            f"{best_cand.slug()} (dp={best_cand.dp}, tp={best_cand.tp}, "
            f"pp={best_cand.pp}, sp={best_cand.sp}, "
            f"accum={best_cand.gradient_accumulation}, "
            f"precision={best_cand.precision}, "
            f"wus={best_cand.weight_update_sharding})"))


def _optimal_max_stage(costs: List[int], n_stages: int) -> int:
    """Heaviest stage of the OPTIMAL contiguous partition — the same
    minimize-the-max objective as parallel/pipeline.partition_stages with
    no activation term, re-implemented locally so the validator never
    imports the parallel layer. If even the best split is
    skewed, the skew is inherent to the model, which is exactly what
    GC009 reports. O(S * n^2) DP over prefix sums; n = layer count."""
    n = len(costs)
    ps = [0]
    for c in costs:
        ps.append(ps[-1] + c)
    INF = float("inf")
    # best[i] = minimal max-stage-sum splitting items[0:i] into k stages,
    # for the current k (rolled)
    best = [0.0] + [INF] * n
    for _ in range(n_stages - 1):
        nxt = [INF] * (n + 1)
        for i in range(n):
            if best[i] == INF:
                continue
            for j in range(i + 1, n + 1):
                v = max(best[i], ps[j] - ps[i])
                if v < nxt[j]:
                    nxt[j] = v
        best = nxt
    return int(min(max(best[i], ps[n] - ps[i]) for i in range(n)
                   if best[i] != INF))


def _build_report(conf, batch_size: Optional[int], walk=None,
                  weight_update_sharding=None, mesh=None):
    """One MemoryReport per validation pass — _check_mesh reuses its
    param counts and _check_hbm its totals. ``walk`` hands over the
    (name, layer, out_type) triples the checker already inferred so the
    report never re-runs the shape walk."""
    from deeplearning4j_tpu_torch.analysis.memory import memory_report
    dp = _dp_size(_mesh_axes(mesh)) or 1
    try:
        return memory_report(
            conf, batch_size=batch_size or 32, layers=walk,
            weight_update_sharding=_wus_mode(weight_update_sharding),
            dp=dp)
    except Exception:
        return None  # inference failures already reported as GC005


def _check_hbm(findings: List[Finding], rep, batch_size: Optional[int],
               hbm_bytes: int) -> None:
    if rep is None or batch_size is None:
        return
    if rep.total_hbm_bytes > hbm_bytes:
        findings.append(Finding(
            "GC007", Severity.WARNING, f"batch={batch_size}",
            f"estimated training footprint "
            f"{rep.total_hbm_bytes / 1024 ** 3:.1f} GiB exceeds the "
            f"{hbm_bytes / 1024 ** 3:.0f} GiB per-chip HBM budget",
            "shard params over more chips, shrink the batch, or enable "
            "gradient_checkpointing()"))


# ---------------------------------------------------------------------------
# MultiLayerConfiguration
# ---------------------------------------------------------------------------

def _conf_precision(conf, precision):
    """The (precision, loss_scale) pair to validate: an explicit kwarg
    wins; otherwise the config's own TrainingConfig.precision/.loss_scale
    (older serialized configs lack the fields — treated as fp32).
    Mirrors the trainers' ``PrecisionPolicy.parse(precision,
    loss_scale=conf.loss_scale)`` semantics: a policy INSTANCE carries
    its own loss_scale, but a preset/dtype STRING inherits the config's
    — so the validator never warns about a hazard the runtime does not
    have."""
    training = getattr(conf, "training", None)
    conf_scale = getattr(training, "loss_scale", None)
    if precision is not None:
        if getattr(precision, "compute_dtype", None) is not None:
            return precision, None  # instance: its own loss_scale rules
        return precision, conf_scale
    return getattr(training, "precision", None), conf_scale


def check_multilayer(conf, *, mesh=None, batch_size: Optional[int] = None,
                     hbm_bytes: Optional[int] = None,
                     weight_update_sharding=None,
                     input_iterator=None,
                     elastic_resize_widths=None,
                     precision=None,
                     autotune_devices: Optional[int] = None
                     ) -> List[Finding]:
    """Validate a MultiLayerConfiguration: a metadata walk, no tensor is
    built. ``autotune_devices``: opt into GC016 at that rank count."""
    from deeplearning4j_tpu_torch.analysis.memory import DEFAULT_HBM_BYTES
    findings: List[Finding] = []
    if not conf.layers:
        findings.append(Finding(
            "GC005", Severity.ERROR, "<config>", "configuration has no "
            "layers", "add at least one layer before build()"))
        return findings
    seen: Dict[str, int] = {}
    for i, layer in enumerate(conf.layers):
        n = getattr(layer, "name", None)
        if n:
            if n in seen:
                findings.append(Finding(
                    "GC001", Severity.ERROR, n,
                    f"duplicate layer name (layers {seen[n]} and {i})",
                    "give each layer a unique name"))
            else:
                seen[n] = i
    out_types = _walk_multilayer_shapes(conf, findings)
    head = conf.layers[-1]
    if not hasattr(head, "compute_loss"):
        findings.append(Finding(
            "GC006", Severity.WARNING, _layer_label(len(conf.layers) - 1, head),
            f"final layer {type(head).__name__} has no loss — fit() will "
            "be rejected (inference-only configs are fine)",
            "end the stack with OutputLayer / RnnOutputLayer / LossLayer"))
    if (conf.training.backprop_type == "truncated_bptt"
            and out_types and out_types[-1] is not None
            and out_types[-1].kind != "rnn"):
        findings.append(Finding(
            "GC005", Severity.ERROR, _layer_label(len(conf.layers) - 1, head),
            "truncated_bptt requires a time-distributed (rnn) output; the "
            f"final layer produces {out_types[-1].kind!r}",
            "use RnnOutputLayer or switch to standard backprop"))
    body = [(_layer_label(i, l), l) for i, l in enumerate(conf.layers[:-1])]
    walk = [(_layer_label(i, l), l, out_types[i])
            for i, l in enumerate(conf.layers)]
    rep = (_build_report(conf, batch_size, walk,
                         weight_update_sharding=weight_update_sharding,
                         mesh=mesh)
           if mesh is not None or batch_size is not None else None)
    counts = ([e.n_params for e in rep.entries[:-1]]
              if rep is not None and len(rep.entries) == len(conf.layers)
              else None)
    _check_mesh(findings, body, mesh, batch_size, counts=counts)
    _check_zero1(findings, [(lbl, l) for lbl, l, _ in walk],
                 _mesh_axes(mesh), weight_update_sharding)
    _check_composition(findings, [(lbl, l) for lbl, l, _ in walk],
                       _mesh_axes(mesh), weight_update_sharding)
    _check_input(findings, _mesh_axes(mesh), input_iterator)
    _check_elastic(findings, [(lbl, l) for lbl, l, _ in walk],
                   _mesh_axes(mesh), batch_size, weight_update_sharding,
                   elastic_resize_widths)
    _check_precision(findings, *_conf_precision(conf, precision))
    if not any(f.severity == Severity.ERROR for f in findings):
        # advisory only, and the comparison assumes a runnable config —
        # same gate as the graph path
        _check_mistuned(findings, conf, walk, _mesh_axes(mesh),
                        batch_size, weight_update_sharding,
                        _conf_precision(conf, precision)[0],
                        autotune_devices)
    _check_hbm(findings, rep, batch_size, hbm_bytes or DEFAULT_HBM_BYTES)
    return findings


# ---------------------------------------------------------------------------
# ComputationGraphConfiguration
# ---------------------------------------------------------------------------

def _lenient_topo(conf, findings: List[Finding]) -> List[str]:
    """Kahn's algorithm that REPORTS cycles/dangling refs instead of
    raising (graph_builder._topo_sort throws; graphcheck must keep
    walking to collect every defect)."""
    nodes = conf.nodes
    dangling = set()
    for name, node in nodes.items():
        for inp in node.inputs:
            if inp not in nodes:
                findings.append(Finding(
                    "GC003", Severity.ERROR, name,
                    f"references unknown input {inp!r}",
                    "add the missing node or fix the input name"))
                dangling.add((name, inp))
    indeg = {n: sum(1 for i in c.inputs if i in nodes)
             for n, c in nodes.items()}
    children: Dict[str, List[str]] = {n: [] for n in nodes}
    for n, c in nodes.items():
        for inp in c.inputs:
            if inp in nodes:
                children[inp].append(n)
    queue = [n for n, d in indeg.items() if d == 0]
    order: List[str] = []
    while queue:
        n = queue.pop(0)
        order.append(n)
        for ch in children[n]:
            indeg[ch] -= 1
            if indeg[ch] == 0:
                queue.append(ch)
    if len(order) != len(nodes):
        cyc = sorted(n for n, d in indeg.items() if d > 0)
        findings.append(Finding(
            "GC002", Severity.ERROR, ",".join(cyc),
            f"graph contains a cycle through {cyc}",
            "break the cycle (a recurrent loop must live inside a "
            "recurrent layer, not the DAG)"))
    return order


def _walk_graph_shapes(conf, order: List[str],
                       findings: List[Finding]) -> Dict[str, InputType]:
    """Shape/dtype inference over the resolvable part of the DAG — the
    lenient counterpart of ``_resolve_shapes``, shared by check_graph
    and the memory walk so types are inferred exactly once per pass."""
    from deeplearning4j_tpu_torch.nn.conf.builder import expected_input_kind
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import auto_preprocessor

    nodes = conf.nodes
    types: Dict[str, InputType] = {}
    for name in order:
        node = nodes[name]
        if node.kind == "input":
            t = conf.input_types.get(name)
            if t is not None:
                types[name] = t
            continue
        if any(i not in types for i in node.inputs):
            continue  # upstream unresolved (missing input_types or errors)
        in_ts = [types[i] for i in node.inputs]
        if node.kind == "layer":
            if len(node.inputs) != 1:
                findings.append(Finding(
                    "GC012", Severity.ERROR, name,
                    f"layer node takes exactly 1 input, got "
                    f"{len(node.inputs)}",
                    "merge multiple inputs with a MergeVertex first"))
                continue
            cur = in_ts[0]
            try:
                pre = node.preprocessor
                if pre is None:
                    pre = auto_preprocessor(cur,
                                            expected_input_kind(node.layer))
                if pre is not None:
                    cur = pre.infer_output_type(cur)
                for path, declared, want in _n_in_conflicts(node.layer, cur):
                    findings.append(Finding(
                        "GC005", Severity.ERROR, name,
                        f"declared {path}={declared} but input "
                        f"{node.inputs[0]!r} produces {want} features "
                        f"({cur})",
                        f"set {path}={want} or fix the upstream node"))
                import copy
                probe = copy.deepcopy(node.layer)
                probe.set_n_in(cur)
                types[name] = probe.infer_output_type(cur)
            except Exception as e:
                findings.append(Finding(
                    "GC005", Severity.ERROR, name,
                    f"shape inference failed: {e}",
                    "check the layer's geometry against its input"))
        else:
            want = node.vertex.n_inputs()
            if want is not None and len(node.inputs) != want:
                findings.append(Finding(
                    "GC012", Severity.ERROR, name,
                    f"vertex {type(node.vertex).__name__} expects {want} "
                    f"input(s), got {len(node.inputs)}",
                    "fix the vertex wiring"))
                continue
            try:
                types[name] = node.vertex.infer_output_type(in_ts)
            except Exception as e:
                findings.append(Finding(
                    "GC005", Severity.ERROR, name,
                    f"vertex shape inference failed: {e}",
                    "check that all vertex inputs have compatible shapes"))
    return types


def check_graph(conf, *, mesh=None, batch_size: Optional[int] = None,
                hbm_bytes: Optional[int] = None,
                weight_update_sharding=None,
                input_iterator=None,
                elastic_resize_widths=None,
                precision=None,
                autotune_devices: Optional[int] = None) -> List[Finding]:
    """Validate a ComputationGraphConfiguration — including configs the
    builder itself would refuse to construct (cycles, dangling refs),
    which is why this walk never calls ``_resolve_shapes``.
    ``autotune_devices``: opt into GC016 at that rank count."""
    from deeplearning4j_tpu_torch.analysis.memory import DEFAULT_HBM_BYTES
    findings: List[Finding] = []
    nodes = conf.nodes
    for name, count in getattr(conf, "duplicate_nodes", ()):
        findings.append(Finding(
            "GC001", Severity.ERROR, name,
            f"node name appears {count} times in the serialized graph "
            "(only the last definition survives loading)",
            "give each node a unique name"))
    if not conf.network_inputs:
        findings.append(Finding(
            "GC003", Severity.ERROR, "<config>",
            "no network inputs declared", "call add_inputs(...)"))
    if not conf.network_outputs:
        findings.append(Finding(
            "GC003", Severity.ERROR, "<config>",
            "no network outputs declared", "call set_outputs(...)"))
    for out in conf.network_outputs:
        if out not in nodes:
            findings.append(Finding(
                "GC003", Severity.ERROR, out,
                "declared network output does not exist",
                "fix set_outputs(...) or add the node"))
    order = _lenient_topo(conf, findings)

    # dead vertices: reverse reachability from the outputs
    parents = {n: [i for i in c.inputs if i in nodes]
               for n, c in nodes.items()}
    live = set()
    stack = [o for o in conf.network_outputs if o in nodes]
    while stack:
        n = stack.pop()
        if n in live:
            continue
        live.add(n)
        stack.extend(parents[n])
    for name in order:
        if name not in live:
            kind = nodes[name].kind
            findings.append(Finding(
                "GC004", Severity.WARNING, name,
                f"{kind} node feeds no network output (dead vertex) — its "
                "params would train on no gradient signal",
                "connect it to an output or remove it"))

    types = _walk_graph_shapes(conf, order, findings)

    # merge-vertex height/width agreement (concat along channels needs
    # matching spatial dims — infer_output_type alone doesn't check)
    from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
    for name in order:
        node = nodes[name]
        if node.kind != "vertex" or not isinstance(node.vertex, MergeVertex):
            continue
        in_ts = [types.get(i) for i in node.inputs]
        cnn = [t for t in in_ts if t is not None and t.kind == "cnn"]
        if len(cnn) > 1 and len({(t.height, t.width) for t in cnn}) > 1:
            findings.append(Finding(
                "GC005", Severity.ERROR, name,
                "MergeVertex inputs have mismatched spatial dims: "
                + ", ".join(f"{t.height}x{t.width}" for t in cnn),
                "pad or pool the branches to a common height/width before "
                "merging"))

    for out in conf.network_outputs:
        node = nodes.get(out)
        if node is None:
            continue
        if node.kind != "layer" or not hasattr(node.layer, "compute_loss"):
            findings.append(Finding(
                "GC006", Severity.WARNING, out,
                "output node has no loss head — fit() will be rejected "
                "(inference-only graphs are fine)",
                "make the output an OutputLayer/RnnOutputLayer/LossLayer "
                "node"))

    heads = set(conf.network_outputs)
    body = [(n, nodes[n].layer) for n in order
            if nodes[n].kind == "layer" and n not in heads]
    walk = [(n, nodes[n].layer, types.get(n)) for n in order
            if nodes[n].kind == "layer"]
    rep = (_build_report(conf, batch_size, walk,
                         weight_update_sharding=weight_update_sharding,
                         mesh=mesh)
           if mesh is not None or batch_size is not None else None)
    counts = None
    if rep is not None:
        by_name = {e.name: e.n_params for e in rep.entries}
        if all(n in by_name for n, _ in body):
            counts = [by_name[n] for n, _ in body]
    _check_mesh(findings, body, mesh, batch_size, counts=counts)
    _check_zero1(findings, [(lbl, l) for lbl, l, _ in walk],
                 _mesh_axes(mesh), weight_update_sharding)
    _check_composition(findings, [(lbl, l) for lbl, l, _ in walk],
                       _mesh_axes(mesh), weight_update_sharding,
                       conf=conf, order=order)
    _check_input(findings, _mesh_axes(mesh), input_iterator)
    _check_elastic(findings, [(lbl, l) for lbl, l, _ in walk],
                   _mesh_axes(mesh), batch_size, weight_update_sharding,
                   elastic_resize_widths)
    _check_precision(findings, *_conf_precision(conf, precision))
    if not any(f.severity == Severity.ERROR for f in findings):
        _check_mistuned(findings, conf, walk, _mesh_axes(mesh),
                        batch_size, weight_update_sharding,
                        _conf_precision(conf, precision)[0],
                        autotune_devices)
        _check_hbm(findings, rep, batch_size,
                   hbm_bytes or DEFAULT_HBM_BYTES)
    return findings


# ---------------------------------------------------------------------------
# dispatch + iteration helpers
# ---------------------------------------------------------------------------

def validate_config(conf, *, mesh=None, batch_size: Optional[int] = None,
                    hbm_bytes: Optional[int] = None,
                    weight_update_sharding=None,
                    input_iterator=None,
                    elastic_resize_widths=None,
                    precision=None,
                    autotune_devices: Optional[int] = None
                    ) -> List[Finding]:
    """Dispatch on configuration type. ``autotune_devices``: opt into the
    GC016 mistuning comparison against the autotuner's best legal config
    at that rank count."""
    if hasattr(conf, "nodes"):
        return check_graph(conf, mesh=mesh, batch_size=batch_size,
                           hbm_bytes=hbm_bytes,
                           weight_update_sharding=weight_update_sharding,
                           input_iterator=input_iterator,
                           elastic_resize_widths=elastic_resize_widths,
                           precision=precision,
                           autotune_devices=autotune_devices)
    return check_multilayer(conf, mesh=mesh, batch_size=batch_size,
                            hbm_bytes=hbm_bytes,
                            weight_update_sharding=weight_update_sharding,
                            input_iterator=input_iterator,
                            elastic_resize_widths=elastic_resize_widths,
                            precision=precision,
                            autotune_devices=autotune_devices)


def iter_config_layers(conf) -> Iterator[Tuple[str, object,
                                               Optional[InputType]]]:
    """Yield (name, layer_conf, output InputType or None) for every layer
    of either config kind, in execution order — the walk MemoryReport
    aggregates over."""
    if hasattr(conf, "nodes"):
        rt = dict(conf.resolved_types or {})
        scratch: List[Finding] = []
        if rt:
            order = conf.topological_order or list(conf.nodes)
        else:
            # leniently-loaded graph (CLI / builder validate): infer the
            # types here so activation memory is not silently dropped
            order = _lenient_topo(conf, scratch)
            rt = _walk_graph_shapes(conf, order, scratch)
        for name in order:
            node = conf.nodes[name]
            if node.kind == "layer":
                yield name, node.layer, rt.get(name)
        return
    scratch = []
    out_types = _walk_multilayer_shapes(conf, scratch)
    for i, layer in enumerate(conf.layers):
        yield _layer_label(i, layer), layer, out_types[i]


def load_config_dict(d: dict):
    """Deserialize a config dict LENIENTLY: the standard ``from_dict``
    paths resolve shapes and throw on broken graphs; this loader
    constructs the object without resolution so graphcheck can report
    every defect. Dispatches on the ``format`` tag."""
    import deeplearning4j_tpu_torch.parallel.expert  # noqa: F401 (MoELayer)
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration, TrainingConfig,
    )
    fmt = d.get("format", "")
    if "ComputationGraph" not in fmt:
        return MultiLayerConfiguration.from_dict(d)
    from deeplearning4j_tpu_torch.nn.conf.graph import GraphVertex
    from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
        ComputationGraphConfiguration, NodeConf,
    )
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
        InputPreProcessor,
    )
    from deeplearning4j_tpu_torch.nn.layers.base import layer_from_dict
    nodes: Dict[str, NodeConf] = {}
    name_counts: Dict[str, int] = {}
    for nd in d["nodes"]:
        name_counts[nd["name"]] = name_counts.get(nd["name"], 0) + 1
        nodes[nd["name"]] = NodeConf(
            name=nd["name"], kind=nd["kind"], inputs=list(nd["inputs"]),
            layer=layer_from_dict(nd["layer"]) if "layer" in nd else None,
            vertex=(GraphVertex.from_dict(nd["vertex"])
                    if "vertex" in nd else None),
            preprocessor=(InputPreProcessor.from_dict(nd["preprocessor"])
                          if "preprocessor" in nd else None))
    conf = ComputationGraphConfiguration(
        nodes=nodes,
        network_inputs=list(d["network_inputs"]),
        network_outputs=list(d["network_outputs"]),
        input_types={k: InputType.from_dict(v)
                     for k, v in d.get("input_types", {}).items()},
        training=TrainingConfig.from_dict(d["training"]))
    # the dict form can carry name collisions the node map cannot:
    # recorded, so check_graph reports GC001 instead of validating the
    # collapsed graph
    conf.duplicate_nodes = [(n, c) for n, c in name_counts.items()
                            if c > 1]
    return conf


# ---------------------------------------------------------------------------
# the CLI's file mode
# ---------------------------------------------------------------------------

def _parse_mesh(spec: Optional[str]) -> Optional[Dict[str, int]]:
    """'dp=8,pp=2' -> {'dp': 8, 'pp': 2}."""
    if not spec:
        return None
    axes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        if not size:
            raise SystemExit(f"bad --mesh entry {part!r}; want axis=size")
        axes[name.strip()] = int(size)
    return axes


def main(argv=None) -> int:
    """``python -m deeplearning4j_tpu_torch.analysis.graphcheck model.json
    [--mesh dp=8,pp=2] [--batch-size N] [--memory]``: load a serialized
    ``MultiLayerConfiguration`` or ``ComputationGraphConfiguration``
    (JSON or YAML, dispatched on its ``format`` tag), run every rule,
    print the findings (and with ``--memory`` the MemoryReport). Exits 1
    when a finding is an ERROR, 0 otherwise, 2 on a usage error."""
    import argparse
    import json
    from deeplearning4j_tpu_torch.analysis.findings import (
        format_findings, has_errors,
    )
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis.graphcheck",
        description="Static validation of a serialized model config.")
    ap.add_argument("config", help="serialized config (.json/.yaml)")
    ap.add_argument("--mesh", default=None,
                    help="mesh axes, e.g. dp=8,pp=2,ep=4")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="global batch size for the dp / memory checks")
    ap.add_argument("--memory", action="store_true",
                    help="print the MemoryReport too")
    args = ap.parse_args(argv)
    with open(args.config, "r", encoding="utf-8") as fh:
        text = fh.read()
    if args.config.endswith((".yaml", ".yml")):
        import yaml
        d = yaml.safe_load(text)
    else:
        d = json.loads(text)
    conf = load_config_dict(d)
    findings = validate_config(conf, mesh=_parse_mesh(args.mesh),
                               batch_size=args.batch_size)
    if findings:
        print(format_findings(findings, header=f"{args.config}:"))
    else:
        print(f"{args.config}: clean")
    if args.memory:
        from deeplearning4j_tpu_torch.analysis.memory import memory_report
        print(memory_report(conf, batch_size=args.batch_size or 32)
              .to_text())
    return 1 if has_errors(findings) else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
