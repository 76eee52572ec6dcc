"""The fixtures of the port's analysis self-checks (the JAX package's
``analysis/fixtures.py``), four families, each rule of each layer with at
least one known-bad and one known-good fixture
(``tests/test_torch_analyze_cli.py`` holds the coverage):

- **graphcheck** (``KNOWN_BAD`` / ``KNOWN_GOOD`` / ``KNOWN_GOOD_FOR``):
  config objects built with the port's builders, the makers of the JAX
  package's family. Each known-bad entry names the rule its defect must
  produce; the known-good ones validate clean; ``KNOWN_GOOD_FOR`` maps a
  rule to the clean fixture that exercises its trigger. The broken
  configs are built directly (dataclass constructors, no ``build()``):
  the builders refuse several of these defects, and graphcheck exists for
  configs that arrive from JSON without a builder. ``python -m
  deeplearning4j_tpu_torch.analysis.graphcheck --self-check`` runs them.
- **torchlint** (``TL_FIXTURES``): per rule a (bad snippet, good twin)
  pair of source strings. The snippets of TL001 and TL003-TL007 each
  define ``step(x)`` and ``capture(graph, x)``, which captures
  ``step(x)`` into ``graph`` (TL006's also ``feed(x)``, which hands the
  capture a new input), so a card can run them: each bad body shows its
  hazard there, each good one replays equal to ``step`` run eagerly.
- **lockcheck** (``LC_FIXTURES``): the JAX package's pairs.
- **shardcheck** (``SC_KNOWN_BAD`` / ``SC_KNOWN_GOOD`` / ``SC_GOOD_FOR``):
  recorded step programs at dp = 2, below.

shardcheck's fixtures: each maker returns ``(StepProgram,
check_kwargs)``. The known-bad steps
are small synthetic steps, each showing exactly its defect; the
known-good steps are the REAL ``ParallelTrainer`` steps at each layout
(off, zero1, zero2, zero2 with accumulation 2, bf16 zero2, the fp32
preset against the net built with no policy, an sp = 2 ring), the GPT's
dense decode step and its paged decode step, so the self-check re-proves
the contracts the parity tests then hold at run time.

The trainer and collective fixtures run inside a ``torch.distributed``
group of two ranks (every rank calls every maker, in the same order; the
makers are cached per process, so each records once); the command line
(``python -m deeplearning4j_tpu_torch.analysis.shardcheck --self-check``)
starts such a group. Every maker takes ``device``: ``None`` means the
card, and raises when there is none (both ranks on the one card, over
gloo); ``"cpu"`` runs them on the CPU. ``SC_PARAMS`` may carry the nets'
weights in ({"mlp": ..., "attn": ..., "gpt": ...}, numpy trees in the
port's layout, e.g. ``convert.params_from_jax``).

``contract_checks(...)`` is the ``--contracts`` gate, on the fixture net
or, given a net factory and a batch, on any net (the smoke runs it on the
full-width GPT).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis.shardcheck import (
    StepProgram, check_step_program, record_step_program,
)
from deeplearning4j_tpu_torch.analysis.findings import Severity
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
from deeplearning4j_tpu_torch.nn.conf.graph_builder import (
    ComputationGraphConfiguration, NodeConf,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    ConvolutionLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM, RnnOutputLayer

# ---------------------------------------------------------------------------
# known-bad: (name, expected_rule, build() -> (conf, validate_kwargs))
# ---------------------------------------------------------------------------

def bad_shape_mismatch():
    """Stacked Dense layers whose declared widths disagree: 784 -> 256
    feeding a layer that claims n_in=128."""
    conf = MultiLayerConfiguration(layers=[
        DenseLayer(n_in=784, n_out=256, activation="relu"),
        DenseLayer(n_in=128, n_out=64, activation="relu"),
        OutputLayer(n_in=64, n_out=10, activation="softmax", loss="mcxent"),
    ])
    return conf, {}


def bad_graph_cycle():
    """a -> b -> c -> a: a DAG with a loop."""
    mk = lambda name, inputs: NodeConf(
        name=name, kind="layer", inputs=inputs,
        layer=DenseLayer(n_in=8, n_out=8, activation="relu"))
    nodes = {
        "in": NodeConf(name="in", kind="input"),
        "a": mk("a", ["c"]),
        "b": mk("b", ["a"]),
        "c": mk("c", ["b"]),
        "out": NodeConf(name="out", kind="layer", inputs=["c"],
                        layer=OutputLayer(n_in=8, n_out=2,
                                          activation="softmax")),
    }
    conf = ComputationGraphConfiguration(
        nodes=nodes, network_inputs=["in"], network_outputs=["out"],
        input_types={"in": InputType.feed_forward(8)})
    return conf, {}


def bad_dangling_vertex():
    """A node referencing an input that does not exist."""
    nodes = {
        "in": NodeConf(name="in", kind="input"),
        "h": NodeConf(name="h", kind="layer", inputs=["ghost"],
                      layer=DenseLayer(n_in=8, n_out=8, activation="relu")),
        "out": NodeConf(name="out", kind="layer", inputs=["h"],
                        layer=OutputLayer(n_in=8, n_out=2,
                                          activation="softmax")),
    }
    conf = ComputationGraphConfiguration(
        nodes=nodes, network_inputs=["in"], network_outputs=["out"],
        input_types={"in": InputType.feed_forward(8)})
    return conf, {}


def bad_dp_indivisible():
    """Fine model, but batch 33 cannot shard over dp=8."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 8}, "batch_size": 33}


def bad_pp_unbalanced():
    """One layer holds ~99% of the params: no contiguous 4-stage split
    can balance, three pipeline stages idle every tick."""
    conf = (NeuralNetConfiguration.builder()
            .weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=4096, activation="relu"))
            .layer(DenseLayer(n_out=4096, activation="relu"))
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(InputType.feed_forward(4096))
            .build())
    return conf, {"mesh": {"pp": 4}, "batch_size": 32}


def bad_zero1_no_dp():
    """zero1 weight-update sharding over a mesh with a single data
    replica: nothing to shard — the trainers reject this at
    construction and graphcheck must reject it statically."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 1}, "batch_size": 32,
                  "weight_update_sharding": "zero1"}


def bad_zero1_tp():
    """zero1 over a tensor-parallel mesh: model-sharded kernels already
    distribute their updater state — the trainers raise, and graphcheck
    must reject the combination statically too."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 2, "model": 4}, "batch_size": 32,
                  "weight_update_sharding": "zero1"}


def bad_zero1_padding():
    """Tiny odd-sized layers over a wide dp axis: pad-to-divisible
    flattened-leaf padding dominates the sharded updater state (every
    (5,)/(4,3)-ish leaf rounds up to a multiple of 8)."""
    conf = (NeuralNetConfiguration.builder()
            .weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=3, activation="relu"))
            .layer(DenseLayer(n_out=5, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(InputType.feed_forward(4))
            .build())
    return conf, {"mesh": {"dp": 8}, "batch_size": 32,
                  "weight_update_sharding": "zero1"}


def bad_zero2_no_dp():
    """zero2 weight-update sharding over a single data replica: same
    static illegality as zero1 (GC011 covers both sharded modes — the
    (dp, chunk) layout is shared; zero2 only changes the gradient
    anchoring)."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 1}, "batch_size": 32,
                  "weight_update_sharding": "zero2"}


def bad_zero2_padding():
    """Tiny odd-sized layers under zero2 over a wide dp axis: the
    pad-to-divisible waste warning must fire for zero2 exactly as for
    zero1 (same flattened-leaf layout)."""
    conf, kw = bad_zero1_padding()
    kw = dict(kw, weight_update_sharding="zero2")
    return conf, kw


def bad_bf16_no_loss_scale():
    """bf16 compute policy with no fp32 loss scale configured: GC015
    warns — half-precision backward gradients that underflow are
    silently zero (benign-ish for bf16's fp32 exponent range, a real
    hazard for fp16; the rule points at the knob either way)."""
    conf, _ = good_mlp()
    conf.training.precision = "bf16"
    return conf, {"mesh": {"dp": 2}, "batch_size": 32}


def bad_fp16_bad_dtype():
    """A precision policy naming a non-float compute dtype: GC015
    errors before the step-boundary casts would die at trace time."""
    conf, _ = good_mlp()
    conf.training.precision = "int8"
    return conf, {"batch_size": 32}


def bad_dp_unsharded_iterator():
    """A dp=8 mesh fed by a plain in-memory iterator: every batch lands
    replicated on the default device and is resharded over 'data'
    inside the step — graphcheck must flag the wasted H2D + reshard."""
    from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 8}, "batch_size": 64,
                  "input_iterator": ListDataSetIterator([])}


def bad_elastic_indivisible():
    """A dp=4 fleet planning to survive down to 3 hosts: global batch 32
    shards over 4 and over 2, but a resize to dp=3 cannot split it —
    the host loss the plan claims to survive would kill the resume."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 4}, "batch_size": 32,
                  "elastic_resize_widths": [3, 2, 1]}


def bad_elastic_grow_indivisible():
    """A scale-up plan to dp=6 on a dp=4 mesh whose global batch of 32
    cannot split 6 ways: the rejoin admission the plan claims to
    support would raise ``ElasticError`` at the post-grow resume —
    rejected statically (grown widths are legal; this one just doesn't
    divide the batch)."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 4}, "batch_size": 32,
                  "elastic_resize_widths": [6]}


def bad_mistuned_dp1():
    """The MLP validated at dp=1 while declaring an 8-chip fleet
    (``autotune_devices=8``): the autotuner's best legal config splits
    the same step ~8 ways, so the analytic mistuning ratio blows the
    GC016 2x threshold — 7 chips idle is exactly the "2-5x lost to
    config mistuning" failure mode the rule exists for."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 1}, "batch_size": 64,
                  "autotune_devices": 8}


def bad_sp_without_attention():
    """An sp=2 sequence-parallel axis over a pure MLP: no attention
    layer exists to ring, so the sp chips idle (GC017 warning)."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 2, "sp": 2}, "batch_size": 8}


def bad_pp_cross_composition():
    """pp composed with sp — a mesh shape no trainer runs (GC017
    error: ParallelTrainer has no pp; the pipeline trainers have no
    sp ring)."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 1, "pp": 2, "sp": 2}, "batch_size": 8}


def bad_pp_with_zero2():
    """zero2 weight-update sharding under pipeline parallelism: the
    pipeline trainers apply the replicated update, so the sharded
    layout would silently never form (GC017 error)."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 2, "pp": 2}, "batch_size": 8,
                  "weight_update_sharding": "zero2"}


def bad_pp_splits_residual():
    """A pp axis deeper than the transformer DAG's single-tensor cut
    points: the extra stage boundaries would have to split a block's
    residual stream (GC017 warning — the GPT LM's pipeline hazard)."""
    from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
    conf = gpt_tiny(vocab_size=16, seq_len=8, n_layers=1)
    return conf, {"mesh": {"dp": 1, "pp": 8}, "batch_size": 8}


def bad_duplicate_name():
    """Two layers both named 'hidden' — the flat-view param contract
    (and every by-name lookup) silently collapses them."""
    conf = MultiLayerConfiguration(layers=[
        DenseLayer(n_in=16, n_out=8, activation="relu", name="hidden"),
        DenseLayer(n_in=8, n_out=8, activation="relu", name="hidden"),
        OutputLayer(n_in=8, n_out=2, activation="softmax", loss="mcxent"),
    ])
    return conf, {}


def bad_dead_vertex():
    """A branch that feeds no network output: its params would train on
    no gradient signal."""
    nodes = {
        "in": NodeConf(name="in", kind="input"),
        "live": NodeConf(name="live", kind="layer", inputs=["in"],
                         layer=DenseLayer(n_in=8, n_out=8,
                                          activation="relu")),
        "dead": NodeConf(name="dead", kind="layer", inputs=["in"],
                         layer=DenseLayer(n_in=8, n_out=8,
                                          activation="relu")),
        "out": NodeConf(name="out", kind="layer", inputs=["live"],
                        layer=OutputLayer(n_in=8, n_out=2,
                                          activation="softmax")),
    }
    conf = ComputationGraphConfiguration(
        nodes=nodes, network_inputs=["in"], network_outputs=["out"],
        input_types={"in": InputType.feed_forward(8)})
    return conf, {}


def bad_missing_loss_head():
    """Stack ending in a plain DenseLayer: fit() would be rejected at
    runtime; graphcheck warns at config time."""
    conf = MultiLayerConfiguration(layers=[
        DenseLayer(n_in=16, n_out=8, activation="relu"),
        DenseLayer(n_in=8, n_out=4, activation="relu"),
    ])
    return conf, {}


def bad_hbm_overflow():
    """The MLP against a deliberately tiny 1 MiB per-chip budget: the
    estimated training footprint (~3.4 MiB) cannot fit."""
    conf, _ = good_mlp()
    return conf, {"batch_size": 64, "hbm_bytes": 1 << 20}


def bad_ep_mismatch():
    """MoE with 3 experts over an ep=2 mesh axis: the stacked expert
    weights cannot shard evenly."""
    from deeplearning4j_tpu_torch.parallel.expert import MoELayer
    conf = (NeuralNetConfiguration.builder()
            .updater("adam", learning_rate=1e-3)
            .weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(MoELayer(n_experts=3, hidden=32, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(16))
            .build())
    return conf, {"mesh": {"dp": 2, "ep": 2}, "batch_size": 32}


def bad_vertex_arity():
    """An L2Vertex (pairwise distance, exactly 2 inputs) wired with 1."""
    from deeplearning4j_tpu_torch.nn.conf.graph import L2Vertex
    nodes = {
        "in": NodeConf(name="in", kind="input"),
        "h": NodeConf(name="h", kind="layer", inputs=["in"],
                      layer=DenseLayer(n_in=8, n_out=8, activation="relu")),
        "d": NodeConf(name="d", kind="vertex", inputs=["h"],
                      vertex=L2Vertex()),
        "out": NodeConf(name="out", kind="layer", inputs=["d"],
                        layer=OutputLayer(n_in=1, n_out=2,
                                          activation="softmax")),
    }
    conf = ComputationGraphConfiguration(
        nodes=nodes, network_inputs=["in"], network_outputs=["out"],
        input_types={"in": InputType.feed_forward(8)})
    return conf, {}


KNOWN_BAD: List[Tuple[str, str, Callable]] = [
    ("duplicate-name", "GC001", bad_duplicate_name),
    ("dead-vertex", "GC004", bad_dead_vertex),
    ("missing-loss-head", "GC006", bad_missing_loss_head),
    ("hbm-overflow", "GC007", bad_hbm_overflow),
    ("ep-mismatch", "GC010", bad_ep_mismatch),
    ("vertex-arity", "GC012", bad_vertex_arity),
    ("shape-mismatch", "GC005", bad_shape_mismatch),
    ("graph-cycle", "GC002", bad_graph_cycle),
    ("dangling-vertex", "GC003", bad_dangling_vertex),
    ("dp-indivisible-batch", "GC008", bad_dp_indivisible),
    ("unbalanced-pp-split", "GC009", bad_pp_unbalanced),
    ("zero1-without-dp", "GC011", bad_zero1_no_dp),
    ("zero1-over-tp-mesh", "GC011", bad_zero1_tp),
    ("zero1-padding-waste", "GC011", bad_zero1_padding),
    ("zero2-without-dp", "GC011", bad_zero2_no_dp),
    ("zero2-padding-waste", "GC011", bad_zero2_padding),
    ("bf16-without-loss-scale", "GC015", bad_bf16_no_loss_scale),
    ("precision-non-float", "GC015", bad_fp16_bad_dtype),
    ("dp-unsharded-iterator", "GC013", bad_dp_unsharded_iterator),
    ("elastic-resize-indivisible", "GC014", bad_elastic_indivisible),
    ("elastic-grow-indivisible", "GC014", bad_elastic_grow_indivisible),
    ("mistuned-single-replica", "GC016", bad_mistuned_dp1),
    ("sp-without-attention", "GC017", bad_sp_without_attention),
    ("pp-cross-composition", "GC017", bad_pp_cross_composition),
    ("pp-with-zero2", "GC017", bad_pp_with_zero2),
    ("pp-splits-residual", "GC017", bad_pp_splits_residual),
]


# ---------------------------------------------------------------------------
# known-good: the seed model families
# ---------------------------------------------------------------------------

def good_mlp():
    conf = (NeuralNetConfiguration.builder()
            .seed(12345)
            .updater("adam", learning_rate=1e-3)
            .weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=256, activation="relu"))
            .layer(DenseLayer(n_out=64, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(784))
            .build())
    return conf, {"mesh": {"dp": 8}, "batch_size": 64}


def good_cnn():
    """LeNet-style stack (the seed's models/lenet.py family)."""
    conf = (NeuralNetConfiguration.builder()
            .updater("adam", learning_rate=1e-3)
            .weight_init("xavier")
            .list()
            .layer(ConvolutionLayer(n_out=8, kernel_size=(5, 5),
                                    stride=(1, 1), activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=16, kernel_size=(5, 5),
                                    stride=(1, 1), activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=64, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(28, 28, 1))
            .build())
    return conf, {"mesh": {"dp": 2}, "batch_size": 32}


def good_rnn():
    conf = (NeuralNetConfiguration.builder()
            .updater("adam", learning_rate=1e-3)
            .weight_init("xavier")
            .list()
            .layer(LSTM(n_out=32, activation="tanh"))
            .layer(RnnOutputLayer(n_out=5, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(16, 20))
            .build())
    return conf, {"batch_size": 16}


def good_graph_merge():
    """Two-branch merge graph (the ComputationGraph seed family)."""
    conf = (NeuralNetConfiguration.builder()
            .updater("adam", learning_rate=1e-3)
            .weight_init("xavier")
            .graph_builder()
            .add_inputs("in_a", "in_b")
            .set_input_types(InputType.feed_forward(12),
                             InputType.feed_forward(8))
            .add_layer("da", DenseLayer(n_out=16, activation="relu"), "in_a")
            .add_layer("db", DenseLayer(n_out=16, activation="relu"), "in_b")
            .add_vertex("merge", MergeVertex(), "da", "db")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"), "merge")
            .set_outputs("out")
            .build())
    return conf, {"mesh": {"dp": 4}, "batch_size": 32}


def good_mlp_zero1():
    """The MLP under zero1 weight-update sharding on a healthy dp=8
    mesh: large layers, negligible padding — must validate clean."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 8}, "batch_size": 64,
                  "weight_update_sharding": "zero1"}


def good_mlp_zero2():
    """The MLP under zero2 on a healthy dp=8 mesh: large layers,
    negligible padding — must validate clean (GC011 legality is the
    same for both sharded modes)."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 8}, "batch_size": 64,
                  "weight_update_sharding": "zero2"}


def good_mlp_bf16_zero2():
    """bf16 compute / fp32 masters with an explicit loss scale, under
    zero2 on a dp=8 mesh: the mixed policy composes with the sharded
    weight update and must validate clean (the GC015 loss-scale warning
    is satisfied by the configured scale)."""
    conf, _ = good_mlp()
    conf.training.precision = "bf16"
    conf.training.loss_scale = 1024.0
    return conf, {"mesh": {"dp": 8}, "batch_size": 64,
                  "weight_update_sharding": "zero2"}


def good_mlp_pipeline():
    """The MLP on a dp=8 mesh fed by a StreamingInputPipeline: the
    trainers attach its device stage to their mesh at fit time, so
    batches land pre-placed in the step's NamedSharding layout — must
    validate clean (no GC013)."""
    from deeplearning4j_tpu_torch.datasets.pipeline import StreamingInputPipeline
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 8}, "batch_size": 64,
                  "input_iterator": StreamingInputPipeline(
                      [], num_shards=1, shard_index=0)}


def good_mlp_elastic():
    """A dp=4 zero1 fleet with a legal resize plan in BOTH directions:
    batch 64 divides every planned shrink width (2 and the
    sole-survivor dp=1, where zero1 degrades to the replicated layout)
    AND the scale-up width 8 a rejoining replacement would grow the
    mesh to, and the large layers keep re-evaluated padding negligible
    at every width — must validate clean."""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 4}, "batch_size": 64,
                  "weight_update_sharding": "zero1",
                  "elastic_resize_widths": [8, 2, 1]}


def good_moe_ep():
    """MoE with 4 experts over an ep=2 mesh: stacked expert weights
    shard evenly — must validate clean (GC010's clean twin)."""
    from deeplearning4j_tpu_torch.parallel.expert import MoELayer
    conf = (NeuralNetConfiguration.builder()
            .updater("adam", learning_rate=1e-3)
            .weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(MoELayer(n_experts=4, hidden=32, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(16))
            .build())
    return conf, {"mesh": {"dp": 2, "ep": 2}, "batch_size": 32}


def good_mlp_pp():
    """Equal-width body layers over a pp=2 mesh: the best contiguous
    stage partition is balanced — must validate clean (GC009's clean
    twin)."""
    conf = (NeuralNetConfiguration.builder()
            .updater("adam", learning_rate=1e-3)
            .weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=128, activation="relu"))
            .layer(DenseLayer(n_out=128, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(128))
            .build())
    return conf, {"mesh": {"dp": 2, "pp": 2}, "batch_size": 32}


def good_mlp_autotuned():
    """The MLP at a well-tuned shape for an 8-chip fleet: all devices
    on the data axis with a batch large enough that compute (which dp
    splits perfectly) dominates the per-step gradient exchange — the
    GC016 ratio lands near 1x and the rule stays quiet. (At SMALL
    batches the same mesh is genuinely comm-bound and the analytic
    model prefers a mixed dp x tp shape — that is the rule working,
    not noise; the clean twin keeps compute dominant so the verdict is
    robust to cost-constant drift.)"""
    conf, _ = good_mlp()
    return conf, {"mesh": {"dp": 8}, "batch_size": 256,
                  "autotune_devices": 8}


def good_gpt_composed():
    """The GPT decoder LM at its composed configuration:
    dp x sp mesh with zero2 weight-update sharding — every GC017
    trigger surface exercised cleanly (sp WITH ring-capable attention,
    no pp cross-composition, cut points unsplit)."""
    from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
    conf = gpt_tiny(vocab_size=16, seq_len=8)
    return conf, {"mesh": {"dp": 2, "sp": 2}, "batch_size": 8,
                  "weight_update_sharding": "zero2"}


KNOWN_GOOD: List[Tuple[str, Callable]] = [
    ("mlp", good_mlp),
    ("gpt-composed", good_gpt_composed),
    ("cnn", good_cnn),
    ("rnn", good_rnn),
    ("graph-merge", good_graph_merge),
    ("moe-ep", good_moe_ep),
    ("mlp-pp-balanced", good_mlp_pp),
    ("mlp-zero1", good_mlp_zero1),
    ("mlp-zero2", good_mlp_zero2),
    ("mlp-bf16-zero2", good_mlp_bf16_zero2),
    ("mlp-sharded-pipeline", good_mlp_pipeline),
    ("mlp-elastic-plan", good_mlp_elastic),
    ("mlp-autotuned", good_mlp_autotuned),
]

#: rule id -> the KNOWN_GOOD fixture that exercises that rule's trigger
#: surface and stays clean (the meta-test's "one KNOWN_GOOD per rule").
KNOWN_GOOD_FOR: Dict[str, str] = {
    "GC001": "mlp",                  # multi-layer stack, unique names
    "GC002": "graph-merge",          # real DAG, acyclic
    "GC003": "graph-merge",          # all refs resolve
    "GC004": "graph-merge",          # every node feeds an output
    "GC005": "cnn",                  # deepest shape-inference walk
    "GC006": "mlp",                  # loss head present
    "GC007": "mlp",                  # memory walk under default budget
    "GC008": "mlp",                  # batch 64 divides dp=8
    "GC009": "mlp-pp-balanced",      # balanced pp=2 partition
    "GC010": "moe-ep",               # 4 experts over ep=2
    "GC011": "mlp-zero1",            # legal zero1 mesh, low padding
    "GC012": "graph-merge",          # merge vertex wired at its arity
    "GC013": "mlp-sharded-pipeline", # dp mesh fed by a sharded pipeline
    "GC014": "mlp-elastic-plan",     # every planned width divides batch
    "GC015": "mlp-bf16-zero2",       # bf16 with an explicit loss scale
    "GC016": "mlp-autotuned",        # already at the tuner's best shape
    "GC017": "gpt-composed",         # dp x sp x zero2 with real attention
}


#: weights to carry into the fixture nets, by net ("mlp", "attn", "gpt")
SC_PARAMS: Dict[str, object] = {}


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    return torch.tensor(np.asarray(tree), device=device)


def _dev(device) -> str:
    """A maker's ``device`` argument as the key its cache is held under
    (``None``: the card, raising without one)."""
    return str(resolve_device(device))


def _init(net, key: str):
    params = SC_PARAMS.get(key)
    return net.init(None if params is None
                    else _tensors(params, net.device))


# ---------------------------------------------------------------------------
# the nets, the mesh, the batch (the JAX fixtures' builders)
# ---------------------------------------------------------------------------

def _sc_mesh(device, n_seq: int = 1):
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel.mesh import MeshContext
    if not dist.is_initialized() or dist.get_world_size() != 2:
        raise RuntimeError(
            "shardcheck's trainer fixtures run in a group of two ranks "
            "(python -m deeplearning4j_tpu_torch.analysis.shardcheck "
            "--self-check starts one)")
    if n_seq > 1:
        return MeshContext.create(n_data=1, n_seq=n_seq, device=device)
    return MeshContext.create(n_data=2, device=device)


def _sc_batch():
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    rng = np.random.default_rng(0)
    return DataSet(rng.normal(size=(8, 16)).astype(np.float32),
                   np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)])


def _sc_net(device: str, precision: Optional[str] = None):
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.core import (
        DenseLayer, OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater("adam", learning_rate=1e-3)
            .weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(16))
            .build())
    if precision is not None:
        conf.training.precision = precision
    return _init(MultiLayerNetwork(conf, device=device), "mlp")


def _sc_attn_net(device: str):
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        SelfAttentionLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(7)
            .updater("adam", learning_rate=1e-3)
            .weight_init("xavier")
            .list()
            .layer(SelfAttentionLayer(n_heads=2, causal=True, block_size=4,
                                      activation="identity"))
            .layer(RnnOutputLayer(n_out=4, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(8, 8))
            .build())
    return _init(MultiLayerNetwork(conf, device=device), "attn")


def _sc_attn_batch():
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    rng = np.random.default_rng(0)
    return DataSet(rng.normal(size=(4, 8, 8)).astype(np.float32),
                   np.eye(4, dtype=np.float32)[rng.integers(0, 4, (4, 8))])


def trainer_program(net, batch, wus: str = "zero1", accum: int = 1,
                    precision: Optional[str] = None, donate: bool = True,
                    mesh=None) -> Tuple[StepProgram, dict]:
    """(program, context) of a real ``ParallelTrainer`` step of ``net``
    on ``batch`` at a layout (the default mesh: dp = 2 on the net's
    device)."""
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer
    trainer = ParallelTrainer(
        net, mesh=mesh if mesh is not None else _sc_mesh(net.device),
        gradient_accumulation=accum, weight_update_sharding=wus,
        donate_params=donate, precision=precision)
    return trainer.step_program(batch), trainer.shardcheck_context()


@lru_cache(maxsize=None)
def _sc_trainer_program(device: str, wus: str = "zero1", accum: int = 1,
                        precision: Optional[str] = None,
                        donate: bool = True):
    """(program, ctx) of a REAL ParallelTrainer step at the given layout
    — one record per distinct config and device per process."""
    return trainer_program(_sc_net(device, precision), _sc_batch(), wus,
                           accum, precision, donate)


@lru_cache(maxsize=None)
def _sc_attn_trainer_program(device: str):
    """A REAL ParallelTrainer step of a causal-attention net on a dp = 1
    x sp = 2 mesh: the ring SC008's claim is held against."""
    return trainer_program(_sc_attn_net(device), _sc_attn_batch(), "off",
                           1, mesh=_sc_mesh(device, n_seq=2))


# -- known-bad makers -------------------------------------------------------

def _leaf(device, *shape, dtype=torch.float32, fill=1.0):
    return torch.full(shape, fill, dtype=dtype, device=device)


def sc_bad_full_allreduce(device=None):
    """Claims zero1, but the gradient is all-reduced whole and every rank
    applies the full update (the defect SC001 exists for)."""
    dev = _dev(device)
    mesh = _sc_mesh(dev)
    params = [_leaf(dev, 16, 8)]
    x = _leaf(dev, 4, 16)

    def step():
        w = params[0]
        y = x @ w
        g = mesh.all_reduce_(x.t() @ y, axis="data")   # full all-reduce
        w.sub_(0.1 * g)
        return (y * y).sum()
    program = record_step_program(step, state=lambda: {"params": params})
    return program, dict(weight_update_sharding="zero1", dp=2,
                         expect_donation=True)


def sc_bad_double_gather(device=None):
    """Two full-size all-gathers of the one param leaf's rows per update
    — one more than the ZeRO contract's single param gather."""
    dev = _dev(device)
    mesh = _sc_mesh(dev)
    params = [_leaf(dev, 64)]                 # this rank's row of 128
    x = _leaf(dev, 4, 16)

    def step():
        row = params[0]
        full = mesh.all_gather(row)                     # gather #1
        y = x @ full.view(16, 8)
        row.mul_(0.999)
        mesh.all_gather(row)                            # gather #2
        return (y * y).sum()
    program = record_step_program(step, state=lambda: {"params": params})
    return program, dict(weight_update_sharding="zero1", dp=2,
                         param_leaf_sizes=[128], expect_donation=True)


def sc_bad_scan_body_gather(device=None):
    """An accumulation loop whose every microbatch re-gathers the sharded
    weights to full size (the repartition hazard the per-update gather
    avoids)."""
    from deeplearning4j_tpu_torch.analysis.steprecord import microbatch
    dev = _dev(device)
    mesh = _sc_mesh(dev)
    params = [_leaf(dev, 64)]
    xs = _leaf(dev, 3, 4, 16)

    def step():
        total = None
        for i in range(3):
            with microbatch(i):
                full = mesh.all_gather(params[0])
                y = xs[i] @ full.view(16, 8)
                loss = (y * y).sum()
                total = loss if total is None else total + loss
        params[0].mul_(0.999)
        return total
    program = record_step_program(step, state=lambda: {"params": params})
    return program, dict(weight_update_sharding="zero1", dp=2,
                         gradient_accumulation=3, expect_donation=True)


def sc_bad_bf16_gated_out(device=None):
    """Claims a bf16 policy, but every product runs in f32 — the
    step-boundary casts never reached the step."""
    dev = _dev(device)
    params = [_leaf(dev, 16, 8)]
    x = _leaf(dev, 4, 16)

    def step():
        y = x @ params[0]
        loss = (y * y).sum()
        params[0].sub_(0.1 * loss)
        return loss
    program = record_step_program(step, state=lambda: {"params": params})
    return program, dict(precision="bf16", expect_donation=True)


def sc_bad_half_masters(device=None):
    """Computes in bf16 (the policy's half) and hands the PARAMS back in
    bf16 too — master weights crossed the step boundary half-precision
    (as new tensors, as the JAX fixture's step returns them)."""
    dev = _dev(device)
    params = [_leaf(dev, 16, 8)]
    x = _leaf(dev, 4, 16)

    def step():
        wh = params[0].to(torch.bfloat16)
        y = x.to(torch.bfloat16) @ wh
        loss = (y.float() ** 2).sum()
        params[0] = wh * 0.9                       # a bf16 master
        return loss
    program = record_step_program(step, state=lambda: {"params": params})
    return program, dict(precision="bf16", expect_donation=True)


def sc_bad_donation_missing(device=None):
    """A step that replaces its params with new tensors instead of
    updating them in place — 2x peak param memory."""
    dev = _dev(device)
    params = [_leaf(dev, 16, 8)]
    x = _leaf(dev, 4, 16)

    def step():
        y = x @ params[0]
        loss = (y * y).sum()
        params[0] = params[0] - 0.1 * loss
        return loss
    program = record_step_program(step, state=lambda: {"params": params})
    return program, dict(expect_donation=True)


def sc_bad_host_callback(device=None):
    """A loss read on the host inside the step (``.item()``, as a debug
    print or a per-step log would): a device-to-host round trip every
    step."""
    dev = _dev(device)
    params = [_leaf(dev, 16, 8)]
    x = _leaf(dev, 4, 16)
    logged = []

    def step():
        y = x @ params[0]
        loss = (y * y).sum()
        logged.append(loss.item())
        params[0].sub_(0.1 * loss)
        return loss
    program = record_step_program(step, state=lambda: {"params": params})
    return program, dict(expect_donation=True)


def sc_bad_comm_model_mismatch(device=None):
    """The real zero1 step checked against a 10x-inflated param count:
    the recorded-vs-model delta blows the SC007 tolerance."""
    program, ctx = _sc_trainer_program(_dev(device), "zero1", 1)
    ctx = dict(ctx)
    ctx["param_count"] = sum(ctx.pop("param_leaf_sizes")) * 10
    return program, ctx


def _gpt_tiny(device: str):
    from deeplearning4j_tpu_torch.models.gpt import gpt_tiny
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    return _init(ComputationGraph(gpt_tiny(vocab_size=8, seq_len=8),
                                  device=device), "gpt")


def _copied(tree):
    return {n: {k: v.clone() for k, v in kv.items()}
            for n, kv in tree.items()}


@lru_cache(maxsize=None)
def _sc_gpt_decode_program(device: str, in_place: bool = True):
    """The REAL token-level decode step of the tiny GPT, its KV caches
    written in place (the engine's contract, SC009's known-good) or
    copied first (the defect)."""
    net = _gpt_tiny(device)
    _, decode = net.decode_fns()
    rows = 2
    caches = net.init_decode_cache(rows)
    n_cache_leaves = 2 * len(net.kv_cache_nodes())
    x = torch.zeros((rows, 1, 8), dtype=net.dtype, device=device)
    pos = torch.zeros((rows,), dtype=torch.int64, device=device)
    out = {}

    def step():
        c = caches if in_place else _copied(caches)
        probs, out["cache"] = decode(net.params, net.states, c, x, pos)
        return probs
    program = record_step_program(step, state=lambda: {
        "params": net.params, "cache": out.get("cache", caches)})
    return program, dict(expect_cache_alias=n_cache_leaves)


def sc_bad_decode_cache_copied(device=None):
    """A decode step claiming in-place KV caches that copies them first:
    every token pays a full-cache copy (SC009's defect)."""
    program, ctx = _sc_gpt_decode_program(_dev(device), False)
    return program, dict(ctx)


@lru_cache(maxsize=None)
def _sc_gpt_paged_decode_program(device: str, in_place: bool = True):
    """The REAL block-paged decode step of the tiny GPT, reading its KV
    state through a page table over a shared pool updated in place (the
    engine's contract, SC010's known-good), or over a copy of the pool
    (the defect)."""
    net = _gpt_tiny(device)
    page_len = net.kv_page_len(2)
    rows = 2
    pages_per_row = net.decode_max_len() // page_len
    pool = net.init_kv_page_pool(rows * pages_per_row + 1, page_len)
    fn = net.paged_decode_fn(page_len)
    n_pool_leaves = 2 * len(net.kv_cache_nodes())
    x = torch.zeros((rows, 1, 8), dtype=net.dtype, device=device)
    pos = torch.zeros((rows,), dtype=torch.int64, device=device)
    tbl = torch.zeros((rows, pages_per_row), dtype=torch.int64,
                      device=device)
    out = {}

    def step():
        p = pool if in_place else _copied(pool)
        probs, out["pool"] = fn(net.params, net.states, p, x, pos, tbl)
        return probs
    program = record_step_program(step, state=lambda: {
        "params": net.params, "pool": out.get("pool", pool)})
    return program, dict(expect_paged_gather=n_pool_leaves)


def sc_bad_paged_pool_copied(device=None):
    """A paged decode step over a copy of the pool: the gathers are all
    there but the pool is resident twice and copied per token (SC010's
    defect)."""
    program, ctx = _sc_gpt_paged_decode_program(_dev(device), False)
    return program, dict(ctx)


def sc_bad_paged_gather_missing(device=None):
    """The DENSE decode step checked against a paged claim: the
    page-table indirection never formed (SC010's other defect)."""
    program, _ = _sc_gpt_decode_program(_dev(device), True)
    return program, dict(expect_paged_gather=4)


def sc_bad_sp_ring_absent(device=None):
    """Claims sp = 2 sequence parallelism over a step run WITHOUT an sp
    axis — no ring shift exists (SC008's defect)."""
    program, ctx = _sc_trainer_program(_dev(device), "off", 1)
    ctx = dict(ctx)
    ctx["sp"] = 2
    return program, ctx


SC_KNOWN_BAD: List[Tuple[str, str, Callable]] = [
    ("zero1-full-allreduce", "SC001", sc_bad_full_allreduce),
    ("zero1-double-gather", "SC002", sc_bad_double_gather),
    ("ga-scan-weight-gather", "SC003", sc_bad_scan_body_gather),
    ("bf16-casts-gated-out", "SC004", sc_bad_bf16_gated_out),
    ("bf16-half-masters", "SC004", sc_bad_half_masters),
    ("donation-missing", "SC005", sc_bad_donation_missing),
    ("host-callback-in-step", "SC006", sc_bad_host_callback),
    ("comm-model-mismatch", "SC007", sc_bad_comm_model_mismatch),
    ("sp-ring-absent", "SC008", sc_bad_sp_ring_absent),
    ("decode-cache-not-donated", "SC009", sc_bad_decode_cache_copied),
    ("paged-decode-pool-not-donated", "SC010", sc_bad_paged_pool_copied),
    ("paged-decode-gather-missing", "SC010", sc_bad_paged_gather_missing),
]


# -- known-good makers ------------------------------------------------------

def sc_good_zero1(device=None):
    return _sc_trainer_program(_dev(device), "zero1", 1)


def sc_good_zero2(device=None):
    return _sc_trainer_program(_dev(device), "zero2", 1)


def sc_good_zero2_ga_scan(device=None):
    return _sc_trainer_program(_dev(device), "zero2", 2)


def sc_good_bf16_zero2(device=None):
    return _sc_trainer_program(_dev(device), "zero2", 1, "bf16")


def sc_good_replicated(device=None):
    return _sc_trainer_program(_dev(device), "off", 1)


def sc_good_sp_ring(device=None):
    return _sc_attn_trainer_program(_dev(device))


def sc_good_gpt_decode(device=None):
    """The serving engine's decode step (caches written in place): SC009
    must find every cache leaf kept."""
    program, ctx = _sc_gpt_decode_program(_dev(device), True)
    return program, dict(ctx)


def sc_good_gpt_paged_decode(device=None):
    """The serving engine's paged decode step: SC010 must find a
    page-table gather per pool leaf and every pool leaf kept."""
    program, ctx = _sc_gpt_paged_decode_program(_dev(device), True)
    return program, dict(ctx)


def sc_good_fp32_preset_identity(device=None):
    """The fp32 PRESET step checked against the step of the net built
    with no policy: SC004 must find them op-and-dtype-identical."""
    program, ctx = _sc_trainer_program(_dev(device), "zero1", 1, "fp32")
    baseline, _ = _sc_trainer_program(_dev(device), "zero1", 1, None)
    ctx = dict(ctx)
    ctx["baseline"] = baseline
    return program, ctx


SC_KNOWN_GOOD: List[Tuple[str, Callable]] = [
    ("zero1-step", sc_good_zero1),
    ("zero2-step", sc_good_zero2),
    ("zero2-ga-scan", sc_good_zero2_ga_scan),
    ("bf16-zero2-step", sc_good_bf16_zero2),
    ("fp32-preset-identity", sc_good_fp32_preset_identity),
    ("replicated-step", sc_good_replicated),
    ("sp-ring-step", sc_good_sp_ring),
    ("gpt-decode-step", sc_good_gpt_decode),
    ("gpt-paged-decode-step", sc_good_gpt_paged_decode),
]

#: rule id -> the SC_KNOWN_GOOD fixture exercising that rule's trigger
#: surface cleanly
SC_GOOD_FOR: Dict[str, str] = {
    "SC001": "zero1-step",            # a reduce-scatter, no full all-reduce
    "SC002": "zero2-step",            # param gathers <= leaves
    "SC003": "zero2-ga-scan",         # no gather inside a microbatch
    "SC004": "bf16-zero2-step",       # half products, fp32 masters
    "SC005": "zero1-step",            # every leaf updated in place
    "SC006": "replicated-step",       # no host read in the step
    "SC007": "zero1-step",            # recorded == model within tolerance
    "SC008": "sp-ring-step",          # sp claim with the ring present
    "SC009": "gpt-decode-step",       # the caches written in place
    "SC010": "gpt-paged-decode-step",  # gathers through the table, pool kept
}


# ---------------------------------------------------------------------------
# the contracts gate
# ---------------------------------------------------------------------------

def _significant(findings) -> List[str]:
    return [str(f) for f in findings if f.severity != Severity.INFO]


def packed_elems(leaf_sizes, dp: int) -> int:
    """Elements of the ZeRO ``(dp, row)`` buffer the leaves pack into."""
    return dp * sum(-(-int(s) // dp) for s in leaf_sizes)


def sharded_update_problems(program: StepProgram, ctx: dict) -> List[str]:
    """zero1 / zero2: one reduce-scatter of the packed gradient a
    microbatch, exactly one full-size param all-gather (the packed
    buffer: the port's deviation from JAX's one a leaf), no full-size
    all-reduce, every leaf kept."""
    problems = _significant(check_step_program(program, **ctx))
    dp, k = ctx["dp"], ctx.get("gradient_accumulation", 1)
    packed = packed_elems(ctx["param_leaf_sizes"], dp)
    rs = [c for c in program.collectives
          if c.kind == "reduce-scatter" and c.elems == packed]
    ags = [c for c in program.collectives
           if c.kind == "all-gather" and c.elems == packed]
    if len(rs) != k:
        problems.append(f"expected {k} reduce-scatter(s) of the packed "
                        f"{packed}-element gradient, found {len(rs)}")
    if len(ags) != 1:
        problems.append(f"expected exactly 1 packed param all-gather, "
                        f"found {len(ags)}")
    if any(c.in_loop_body for c in ags):
        problems.append("the param all-gather ran inside a microbatch")
    return problems


def replicated_problems(program: StepProgram, ctx: dict) -> List[str]:
    """off: one all-reduce of the whole flat gradient a microbatch."""
    problems = _significant(check_step_program(program, **ctx))
    n = sum(ctx["param_leaf_sizes"])
    k = ctx.get("gradient_accumulation", 1)
    ars = [c for c in program.collectives
           if c.kind == "all-reduce" and c.elems == n]
    if len(ars) != k:
        problems.append(f"expected {k} all-reduce(s) of the {n}-element "
                        f"gradient, found {len(ars)}")
    return problems


def accumulation_problems(program: StepProgram, ctx: dict) -> List[str]:
    """zero2 with accumulation: the sharded-update contract, the
    microbatches recorded, no gather inside one."""
    problems = sharded_update_problems(program, ctx)
    k = ctx["gradient_accumulation"]
    if program.microbatches != k:
        problems.append(f"recorded {program.microbatches} microbatches, "
                        f"the trainer claims {k}")
    body = [c for c in program.collectives
            if c.in_loop_body and c.kind == "all-gather"]
    if body:
        problems.append(f"{len(body)} all-gather(s) inside a microbatch")
    return problems


def bf16_problems(program: StepProgram, ctx: dict) -> List[str]:
    """bf16: half products (or kernels), f32 masters / updater / loss."""
    problems = sharded_update_problems(program, ctx)
    halves = (program.dot_dtypes()["bf16"]
              + sum(n for (_, dt), n in program.kernel_dtypes().items()
                    if dt == "bf16"))
    if not halves:
        problems.append("no bf16 product or kernel in the step — the "
                        "policy's casts were gated out")
    for role in ("params", "updater", "loss"):
        if any(dt in ("bf16", "f16")
               for dt in program.boundary.get(role, ())):
            problems.append(f"{role} left the step in half precision")
    return problems


def sp_problems(program: StepProgram, ctx: dict) -> List[str]:
    """sp = 2: the ring's point-to-point shifts on the sp axis."""
    problems = _significant(check_step_program(program, **ctx))
    ring = [c for c in program.collectives
            if c.kind == "collective-permute" and c.axis == "sp"]
    if not ring:
        problems.append("no ring shift on the sp axis")
    return problems


#: the contract gate's layouts on the dp = 2 mesh: (label, mode,
#: accumulation, precision, the problems it checks)
CONTRACT_LAYOUTS = (
    ("off: one flat gradient all-reduce", "off", 1, None,
     replicated_problems),
    ("zero1: reduce-scatter + one packed gather, no full AR", "zero1", 1,
     None, sharded_update_problems),
    ("zero2: reduce-scatter + one packed gather, no full AR", "zero2", 1,
     None, sharded_update_problems),
    ("zero2 k=2: per-microbatch reduce-scatter, no body gather", "zero2",
     2, None, accumulation_problems),
    ("bf16 zero2: half compute, fp32 masters/loss", "zero2", 1, "bf16",
     bf16_problems),
)


def contract_checks(net_factory: Optional[Callable] = None, batch=None,
                    sp_net_factory: Optional[Callable] = None,
                    sp_batch=None, fp32_identity: bool = True,
                    device=None,
                    ) -> List[Tuple[str, Callable[[], List[str]]]]:
    """The ``--contracts`` gate: (label, check) pairs, each check
    recording one real ``ParallelTrainer`` step and returning its
    problems (``CONTRACT_LAYOUTS``, the fp32 preset against no policy,
    the sp = 2 ring). ``net_factory(precision)`` builds a fresh net
    (default: the fixture MLP) and ``batch`` is its global batch;
    ``sp_net_factory()`` / ``sp_batch`` the ring's (default: the fixture
    attention net). The fixture nets run on ``device`` (``None``: the
    card, raising without one); a factory's nets on their own device."""
    if net_factory is None:
        def program(wus, k=1, precision=None):
            return _sc_trainer_program(_dev(device), wus, k, precision)
    else:
        def program(wus, k=1, precision=None):
            return trainer_program(net_factory(precision), batch, wus, k,
                                   precision)
    if sp_net_factory is None:
        def sp_program():
            return _sc_attn_trainer_program(_dev(device))
    else:
        def sp_program():
            net = sp_net_factory()
            return trainer_program(net, sp_batch, "off", 1,
                                   mesh=_sc_mesh(net.device, n_seq=2))

    checks = [(label, lambda w=wus, k=k, pr=prec, fn=fn: fn(
        *program(w, k, pr)))
        for label, wus, k, prec, fn in CONTRACT_LAYOUTS]
    if fp32_identity:
        def fp32():
            prog, ctx = program("zero1", 1, "fp32")
            base, _ = program("zero1", 1, None)
            return _significant(check_step_program(prog, baseline=base,
                                                   **ctx))
        checks.append(("fp32 preset: op-and-dtype-identical to no policy",
                       fp32))
    checks.append(("sp=2: the ring formed", lambda: sp_problems(
        *sp_program())))
    return checks


# ---------------------------------------------------------------------------
# torchlint fixtures: rule -> (bad snippet firing exactly it, clean twin)
# ---------------------------------------------------------------------------
#
# The captured-code pairs (TL001, TL003-TL007) define step(x), the
# function a graph captures, and capture(graph, x), which captures it;
# the card phase of chip_smoke.py runs them under torch.cuda.graph. The
# autograd.Function pairs (TL009-TL011) define one Function each.

_CAPTURE = """

def capture(graph, x):
    with torch.cuda.graph(graph):
        return step(x)
"""


def _captured(body: str, head: str = "import torch\n") -> str:
    """A snippet whose ``step(x)`` (``body`` its statements) is captured by
    ``capture(graph, x)``."""
    return f"{head}\n\ndef step(x):\n{body}{_CAPTURE}"


#: TL006: the static input is the runner's buffer; feed(x) hands the
#: capture a new input before a replay
_STATIC_INPUT = """\
import torch


class Runner:
    def __init__(self):
        self.buf = None
        self.out = None

    def capture(self, graph, x):
        self.buf = x
        with torch.cuda.graph(graph):
            self.out = self.buf * 2
        return self.out

    def feed(self, x):
        {feed}


RUNNER = Runner()
capture, feed = RUNNER.capture, RUNNER.feed


def step(x):
    return x * 2
"""

_FUNCTION = """\
import torch
from deeplearning4j_tpu_torch.analysis.steprecord import note_launch


def _double_kernel(x):
    note_launch("double", "kernel", x.numel(), x)
    return x * 2


class Double(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _double_kernel(x)

    @staticmethod{once}
    def backward(ctx, grad):
        return _double_kernel(grad)
"""

TL_FIXTURES: Dict[str, Tuple[str, str]] = {
    # a scalar read syncs: the capture raises
    "TL001": (_captured("    return x * float(x.sum())\n"),
              _captured("    return x * x.sum()\n")),
    # a branch on a tensor: the capture keeps one side
    "TL002": (_captured("    if x.sum() > 0:\n        return x\n"
                        "    return -x\n"),
              _captured("    return torch.where(x.sum() > 0, x, -x)\n")),
    # a copy to the host syncs: the capture raises
    "TL003": (_captured("    return (x * 2).cpu().to(x.device)\n"),
              _captured("    return (x * 2).clone()\n")),
    # a boolean mask's result size is data: the capture raises
    "TL004": (_captured("    return x * x[x > 0].sum()\n"),
              _captured("    return x * torch.where(x > 0, x, "
                        "torch.zeros_like(x)).sum()\n")),
    # a host draw is taken once, at capture: replays reuse it
    "TL005": (_captured("    return x + np.random.normal()\n",
                        "import numpy as np\nimport torch\n"),
              # the draw rides in with the input (its last row)
              _captured("    return x[:-1] + x[-1]\n")),
    # the static input rebound: the replay reads the old storage
    "TL006": (_STATIC_INPUT.format(feed="self.buf = x.clone()"),
              _STATIC_INPUT.format(feed="self.buf.copy_(x)")),
    # a host timer in the capture is read once: replays reuse its value
    # (its fraction of a second, which float32 keeps to 1e-7 whatever
    # the clock's origin)
    "TL007": (_captured("    t0 = time.perf_counter() % 1.0\n"
                        "    return x * 2 + t0\n",
                        "import time\nimport torch\n"),
              "import time\nimport torch\n\n\n"
              "def step(x):\n    return x * 2\n\n\n"
              "def timed(x):\n    t0 = time.perf_counter()\n"
              "    y = step(x)\n    torch.cuda.synchronize()\n"
              "    return y, time.perf_counter() - t0\n" + _CAPTURE),
    # TL008: the bad snippet's suppression silences nothing; the good
    # twin's is live, so neither TL001 (suppressed) nor TL008 fires
    "TL008": (_captured("    return x * 2  # torchlint: disable=TL001 "
                        "-- stale\n"),
              _captured("    return x * float(x.sum())  # torchlint: "
                        "disable=TL001 -- demo\n")),
    # one gradient for two inputs
    "TL009": ("import torch\n\n\nclass Scale(torch.autograd.Function):\n"
              "    @staticmethod\n    def forward(ctx, x, factor):\n"
              "        ctx.factor = factor\n        return x * factor\n\n"
              "    @staticmethod\n    def backward(ctx, grad):\n"
              "        return (grad * ctx.factor,)\n",
              "import torch\n\n\nclass Scale(torch.autograd.Function):\n"
              "    @staticmethod\n    def forward(ctx, x, factor):\n"
              "        ctx.factor = factor\n        return x * factor\n\n"
              "    @staticmethod\n    def backward(ctx, grad):\n"
              "        return grad * ctx.factor, None\n"),
    # the backward reads what forward never saved
    "TL010": ("import torch\n\n\nclass Square(torch.autograd.Function):\n"
              "    @staticmethod\n    def forward(ctx, x):\n"
              "        return x * x\n\n"
              "    @staticmethod\n    def backward(ctx, grad):\n"
              "        x, = ctx.saved_tensors\n        return 2 * x * grad\n",
              "import torch\n\n\nclass Square(torch.autograd.Function):\n"
              "    @staticmethod\n    def forward(ctx, x):\n"
              "        ctx.save_for_backward(x)\n        return x * x\n\n"
              "    @staticmethod\n    def backward(ctx, grad):\n"
              "        x, = ctx.saved_tensors\n        return 2 * x * grad\n"),
    # a kernel's backward that a double backward would run through
    "TL011": (_FUNCTION.format(once=""),
              _FUNCTION.format(
                  once="\n    @torch.autograd.function.once_differentiable")),
}


#: the captured-code rules whose pairs a card runs (capture_outcome)
TL_CAPTURE_RULES = ("TL001", "TL003", "TL004", "TL005", "TL006", "TL007")
#: the inputs a capture pair runs on: their shape and their seed
CAPTURE_SHAPE = (4, 8)
CAPTURE_SEED = 0


def capture_outcome(rule: str, which: str = "bad", device=None) -> dict:
    """Run a captured-code pair of ``TL_FIXTURES`` on the card: warm
    ``step`` up eagerly, capture it under ``torch.cuda.graph`` through the
    snippet's ``capture(graph, x)`` on a static input, hand the capture a
    new input (the snippet's ``feed(x)``, else a copy into the static
    input), replay, and hold the replay's output against ``step`` run
    eagerly on the new input, bit for bit. ``device``: ``None`` the card
    (raising without one). Returns ``{rule, which, captured, error,
    replay_equal, max_abs_diff, hazard_shown}``; ``hazard_shown`` is what
    the fixture promises: for a bad body, a capture that raised or a
    replay unequal to eager; for a good one, a capture whose replay
    equals eager."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("a CUDA graph capture needs the card")
    src = TL_FIXTURES[rule][("bad", "good").index(which)]
    ns: dict = {}
    exec(compile(src, f"<{rule}-{which}>", "exec"), ns)
    gen = torch.Generator().manual_seed(CAPTURE_SEED)
    x0, x1 = (torch.randn(CAPTURE_SHAPE, generator=gen).to(dev)
              for _ in range(2))
    static = x0.clone()
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        ns["step"](x0.clone())                 # warm-up, as the runners do
    main.wait_stream(side)
    torch.cuda.synchronize(dev)
    rec = dict(rule=rule, which=which, captured=False, error=None,
               replay_equal=None, max_abs_diff=None)
    graph = torch.cuda.CUDAGraph()
    try:
        out = ns["capture"](graph, static)
        rec["captured"] = True
    except Exception as e:  # noqa: BLE001 — the hazard being shown
        rec["error"] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    finally:
        # a failed capture leaves torch.cuda.graph's side stream current
        torch.cuda.set_stream(main)
        torch.cuda.synchronize(dev)
    if rec["captured"]:
        if "feed" in ns:
            ns["feed"](x1)
        else:
            static.copy_(x1)
        graph.replay()
        torch.cuda.synchronize(dev)
        want = ns["step"](x1.clone())
        same = (out.shape == want.shape and out.dtype == want.dtype
                and bool(torch.equal(out, want)))
        rec["replay_equal"] = same
        if out.shape == want.shape:
            rec["max_abs_diff"] = float((out - want).abs().max())
    del graph
    rec["hazard_shown"] = (
        (not rec["captured"] or rec["replay_equal"] is False)
        if which == "bad" else bool(rec["replay_equal"]))
    return rec


# ---------------------------------------------------------------------------
# lockcheck fixtures: rule -> (bad snippet firing exactly it, clean twin)
# ---------------------------------------------------------------------------
#
# Source-text pairs like the torchlint family (the JAX package's LC
# family, kept as the port's own copy): the bad snippet is the
# smallest class exhibiting exactly one concurrency hazard, the good
# twin is the same class with the repo's canonical fix (consistent lock
# order, block-outside-lock, predicate while loop, locked writes,
# join-on-teardown, notify-under-lock, live suppressions).

LC_FIXTURES: Dict[str, Tuple[str, str]] = {
    # two methods take the same two locks in opposite orders
    "LC001": ("""\
import threading

class Broker:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def put(self):
        with self._a:
            with self._b:
                pass

    def get(self):
        with self._b:
            with self._a:
                pass
""", """\
import threading

class Broker:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def put(self):
        with self._a:
            with self._b:
                pass

    def get(self):
        with self._a:
            with self._b:
                pass
"""),
    # a sleep inside the held region stalls every waiter
    "LC002": ("""\
import threading
import time

class Refresher:
    def __init__(self):
        self._lock = threading.Lock()
        self.value = None

    def refresh(self):
        with self._lock:
            time.sleep(0.5)
""", """\
import threading
import time

class Refresher:
    def __init__(self):
        self._lock = threading.Lock()
        self.value = None

    def refresh(self):
        time.sleep(0.5)
        with self._lock:
            pass
"""),
    # bare if+wait sees stale state on spurious/stolen wakeups
    "LC003": ("""\
import threading

class Mailbox:
    def __init__(self):
        self._cond = threading.Condition()
        self._items = []

    def get(self):
        with self._cond:
            if not self._items:
                self._cond.wait()
            return self._items.pop()
""", """\
import threading

class Mailbox:
    def __init__(self):
        self._cond = threading.Condition()
        self._items = []

    def get(self):
        with self._cond:
            while not self._items:
                self._cond.wait()
            return self._items.pop()
"""),
    # the counter is locked in add() but raced in reset()
    "LC004": ("""\
import threading

class Tally:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def add(self, n):
        with self._lock:
            self.total += n

    def reset(self):
        self.total = 0
""", """\
import threading

class Tally:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def add(self, n):
        with self._lock:
            self.total += n

    def reset(self):
        with self._lock:
            self.total = 0
"""),
    # stop() signals the loop but never joins the thread
    "LC005": ("""\
import threading

class Poller:
    def __init__(self):
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            self._stop.wait(0.1)

    def stop(self):
        self._stop.set()
""", """\
import threading

class Poller:
    def __init__(self):
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            self._stop.wait(0.1)

    def stop(self):
        self._stop.set()
        self._thread.join()
"""),
    # notify_all without holding the condition: RuntimeError at runtime
    "LC006": ("""\
import threading

class Gate:
    def __init__(self):
        self._cond = threading.Condition()
        self._open = False

    def signal(self):
        self._cond.notify_all()
""", """\
import threading

class Gate:
    def __init__(self):
        self._cond = threading.Condition()
        self._open = False

    def signal(self):
        with self._cond:
            self._open = True
            self._cond.notify_all()
"""),
    # LC007: the bad snippet's suppression silences nothing (the sleep
    # it once excused is gone); the good twin's suppression is live, so
    # neither LC002 (suppressed) nor LC007 (used) fires
    "LC007": ("""\
import threading

class Idle:
    def __init__(self):
        self._lock = threading.Lock()

    def poke(self):
        with self._lock:
            pass  # lockcheck: disable=LC002 -- the sleep was removed
""", """\
import threading
import time

class Napper:
    def __init__(self):
        self._lock = threading.Lock()

    def nap(self):
        with self._lock:
            time.sleep(0.01)  # lockcheck: disable=LC002 -- demo: bounded nap under a private lock
"""),
    # close() forgets the armed one-shot Timer: it fires after teardown
    "LC008": ("""\
import threading

class Debounce:
    def __init__(self):
        self._timer = threading.Timer(5.0, self._fire)
        self._timer.start()

    def _fire(self):
        pass

    def close(self):
        self._fire()
""", """\
import threading

class Debounce:
    def __init__(self):
        self._timer = threading.Timer(5.0, self._fire)
        self._timer.start()

    def _fire(self):
        pass

    def close(self):
        self._timer.cancel()
"""),
}
