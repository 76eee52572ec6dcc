"""The port's cost model and watchers (``profiling/cost.py``,
``profiling/watchers.py``, the containers' ``cost_analysis``) on the
CPU: the cost and watcher cases of ``tests/test_profiling.py`` on the
port, the kernels' FLOP formulas against ``FlopCounterMode``'s count of
their plain versions (so a step counts the same whichever path runs),
and ``cost_analysis`` leaving the net as it found it. The weight-update
byte models are held against the JAX package's on the same arguments.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from deeplearning4j_tpu.profiling import cost as jcost

from deeplearning4j_tpu_torch.analysis import steprecord
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
from deeplearning4j_tpu_torch.models.gpt import gpt_decoder
from deeplearning4j_tpu_torch.models.lenet import lenet_mnist
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import tree_leaves
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import fused_lstm as fl
from deeplearning4j_tpu_torch.optimize.training_stats import TrainingStats
from deeplearning4j_tpu_torch.profiling import cost
from deeplearning4j_tpu_torch.profiling import watchers as W
from deeplearning4j_tpu_torch.profiling.cost import (
    analytic_mfu, peak_flops,
)
from deeplearning4j_tpu_torch.profiling.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.profiling.tracer import Tracer
from deeplearning4j_tpu_torch.profiling.watchers import (
    CompileWatcher, DeviceMemoryWatermark, report_compile,
)


def counted(fn, *args, **kw) -> int:
    with FlopCounterMode(display=False) as c:
        fn(*args, **kw)
    return c.get_total_flops()


# ---------------------------------------------------------------- watchers

def test_compile_watcher_counts_compiles():
    """Each compile a site reports (an nvcc build, a CUDA-graph capture)
    is counted and timed by an installed watcher, spanned on its tracer,
    and not after ``uninstall``; install and uninstall are idempotent."""
    reg, tracer = MetricsRegistry(), Tracer()
    w = CompileWatcher(registry=reg, tracer=tracer)
    w.install().install()
    try:
        report_compile("nvcc", 2.5, "flash_attn_fwd")
        report_compile("cuda_graph", 0.25, "decode:8")
        report_compile("cuda_graph", 0.5, "predict:32")
        report_compile("unknown", 1.0)
    finally:
        w.uninstall()
        w.uninstall()
    report_compile("nvcc", 1.0, "after")
    assert not w.installed
    assert w.counts() == {"nvcc": 1, "cuda_graph": 2, "gxx": 0}
    assert reg.counter("nvcc_build_seconds_total").value == 2.5
    assert reg.counter("cuda_graph_capture_seconds_total").value == 0.75
    assert reg.get("compile_seconds").count == 3
    names = [e["name"] for e in tracer.export()["traceEvents"]
             if e.get("ph") == "X"]
    assert names.count("compile:cuda_graph") == 2
    assert names.count("compile:nvcc") == 1


def test_compile_watcher_wrap_warns_on_shape_change(caplog):
    reg = MetricsRegistry()
    w = CompileWatcher(registry=reg, tracer=Tracer())
    calls = []
    fn = w.wrap(lambda x: calls.append(np.shape(x)), "train_step")
    with caplog.at_level(logging.WARNING,
                         logger="deeplearning4j_tpu_torch.profiling.watchers"):
        fn(np.zeros((4, 2)))
        fn(np.zeros((4, 2)))   # same signature: silent
        assert reg.counter("jit_shape_recompiles_total").value == 0
        fn(np.zeros((8, 2)))   # shape change: counted + warned
    assert reg.counter("jit_shape_recompiles_total").value == 1
    assert any("argument shapes changed" in r.message
               for r in caplog.records)
    assert len(calls) == 3  # pass-through untouched


def test_memory_watermark_sampler_cpu_safe():
    """Without a card the sampler is a no-op that never raises, and its
    thread is gone after ``stop()``."""
    reg = MetricsRegistry()
    s = DeviceMemoryWatermark(registry=reg, interval_s=0.01)
    assert s.sample() is None
    assert W.device_memory_stats("cpu") is None
    before = set(threading.enumerate())
    s.start()
    s.start()   # idempotent while running
    time.sleep(0.05)
    started = [t for t in threading.enumerate() if t not in before]
    assert [t.name for t in started] == ["device-mem-watermark"]
    s.stop()
    assert not any(t.is_alive() for t in started)
    assert set(threading.enumerate()) <= before
    assert reg.get("device_bytes_in_use") is None


def test_memory_watermark_ratchets(monkeypatch):
    seq = iter([{"bytes_in_use": 100}, {"bytes_in_use": 900},
                {"bytes_in_use": 300}])
    monkeypatch.setattr(W, "device_memory_stats",
                        lambda device=None: next(seq))
    reg = MetricsRegistry()
    s = DeviceMemoryWatermark(registry=reg)
    for _ in range(3):
        s.sample()
    assert reg.gauge("device_bytes_in_use").value == 300  # latest
    assert reg.gauge("device_bytes_in_use_watermark").value == 900
    assert s.watermark_bytes == 900


# ------------------------------------------------------- cost analysis / MFU

def test_analytic_mfu_arithmetic():
    assert analytic_mfu(1e12, 0.5, 2e12) == pytest.approx(1.0)
    assert analytic_mfu(1e12, 1.0, 2e12) == pytest.approx(0.5)
    assert analytic_mfu(1e12, 1.0, 2e12, n_chips=2) == pytest.approx(0.25)
    assert analytic_mfu(0, 1.0, 2e12) is None
    assert analytic_mfu(1e12, 0.0, 2e12) is None
    assert analytic_mfu(1e12, 1.0, None) is None


def test_peak_flops_table():
    """The card's row (NVIDIA's published dense bf16 figure for the H100
    SXM5) by the name ``torch.cuda.get_device_name`` gives, the CPU's
    nominal row, and the JAX package's rows as they are."""
    assert peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert cost.H100_TF32_FLOPS / 3 == pytest.approx(164.9e12)
    assert peak_flops("cpu") == 1e12
    assert peak_flops("quantum abacus") is None
    for kind in ("TPU v5 lite", "TPU v4", "TPU v6e", "cpu"):
        assert peak_flops(kind) == jcost.peak_flops(kind)


def test_lenet_train_step_cost_matches_hand_count():
    """LeNet's count against the hand count of its forward (valid
    convolutions 28->24->12->8->4, 2 FLOPs a MAC): a step is about 3x the
    forward, in the JAX test's 2.5-4x band."""
    B = 8
    rng = np.random.default_rng(0)
    ds = DataSet(rng.normal(size=(B, 28, 28, 1)).astype(np.float32),
                 np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)])
    net = MultiLayerNetwork(lenet_mnist(), device="cpu").init()
    c = net.cost_analysis(ds)
    fwd = 2 * (288_000 + 1_600_000 + 400_000 + 5_000) * B
    flops = c["flops_per_step"]
    assert 2.5 * fwd <= flops <= 4.0 * fwd, (flops, fwd)
    assert c["flops_per_example"] == pytest.approx(flops / B)
    assert c["bytes_accessed"] > 0
    assert c["arithmetic_intensity"] == pytest.approx(
        flops / c["bytes_accessed"])
    assert c["batch"] == B
    # a single net's step issues no collective: 0, as the JAX package's
    # single-device program (the collectives the counted pass issued)
    assert c["comm_bytes_hlo"] == 0
    assert c["device_kind"] == "cpu"
    assert c["peak_flops_per_chip"] == 1e12
    assert analytic_mfu(flops, 0.01, c["peak_flops_per_chip"]) \
        == pytest.approx(flops / 1e10)


def graph_conf():
    return (NeuralNetConfiguration.builder().seed(3)
            .updater("sgd", learning_rate=0.1).weight_init("xavier")
            .graph_builder()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_out=16, activation="relu"), "in")
            .add_layer("out", OutputLayer(n_out=4, activation="softmax",
                                          loss="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(8)).build())


def test_graph_container_cost_analysis():
    rng = np.random.default_rng(1)
    ds = DataSet(rng.normal(size=(4, 8)).astype(np.float32),
                 np.eye(4, dtype=np.float32)[rng.integers(0, 4, 4)])
    net = ComputationGraph(graph_conf(), device="cpu").init()
    c = net.cost_analysis(ds)
    # dense 8->16 and head 16->4, forward and backward
    assert c["flops_per_step"] and c["flops_per_step"] > 0
    assert c["batch"] == 4


def test_training_stats_folds_cost_analysis():
    s = TrainingStats()
    s.record("step", 0.01)
    s.record("step", 0.01)
    s.set_cost({"flops_per_step": 2e9, "peak_flops_per_chip": 1e12,
                "bytes_accessed": 1e6})
    e = s.export()
    assert e["cost_analysis"]["flops_per_step"] == 2e9
    assert e["analytic_mfu"] == pytest.approx(0.2)
    s2 = TrainingStats()
    s2.set_cost({"flops_per_step": 2e9, "peak_flops_per_chip": 1e12})
    assert "analytic_mfu" not in s2.export()


@pytest.mark.parametrize("args", [
    (10, 2, 4, 1, "off"), (10, 2, 4, 4, "zero1"), (10_001, 8, 2, 2,
                                                   "zero2"),
    (7, 1, 4, 1, "off")])
def test_weight_update_byte_models_are_the_jax_packages(args):
    P, dp, b, k, mode = args
    assert cost.dp_comm_bytes_per_update(P, dp, b, k, mode) \
        == jcost.dp_comm_bytes_per_update(P, dp, b, k, mode)
    for upd in ("adam", "sgd", "nesterovs"):
        assert cost.dp_updater_hbm_bytes(P, upd, dp, b, mode) \
            == jcost.dp_updater_hbm_bytes(P, upd, dp, b, mode)
    assert cost.dp_gradient_hbm_bytes(P, dp, b, mode) \
        == jcost.dp_gradient_hbm_bytes(P, dp, b, mode)


# ------------------------------------------------------- the kernels' FLOPs

def _attn(B=2, H=2, T=24, D=8):
    g = torch.Generator().manual_seed(0)
    q, k, v, d_out = (torch.randn(B, H, T, D, generator=g)
                      for _ in range(4))
    return q, k, v, d_out


@pytest.mark.parametrize("causal", [False, True])
def test_flash_formulas_equal_the_plain_versions_count(causal):
    """K4's formula is the counter's count of its plain version, K5's and
    K6's of theirs (the backward's recompute of P included), and the
    autograd function's forward plus backward counts all three."""
    q, k, v, d_out = _attn()
    B, H, T, D = q.shape
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal)
    dvec = fa.attention_dvec(d_out, out)
    assert counted(fa.flash_attention_plain, q, k, v, causal=causal) \
        == fa.flash_fwd_flops(B, H, T, D)
    assert counted(fa.flash_attention_dq, q, k, v, d_out, lse, dvec,
                   causal=causal) == fa.flash_dq_flops(B, H, T, D)
    assert counted(fa.flash_attention_dkv, q, k, v, d_out, lse, dvec,
                   causal=causal) == fa.flash_dkv_flops(B, H, T, D)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

    def step():
        fa.flash_attention(qg, kg, vg, causal=causal).backward(d_out)
    assert counted(step) == (fa.flash_fwd_flops(B, H, T, D)
                             + fa.flash_dq_flops(B, H, T, D)
                             + fa.flash_dkv_flops(B, H, T, D))


def _lstm(T=5, B=3, H=8):
    g = torch.Generator().manual_seed(1)
    xz = torch.randn(T, B, 4 * H, generator=g)
    rw = torch.randn(H, 4 * H, generator=g) * 0.1
    pw = torch.randn(3, H, generator=g) * 0.1
    h0, c0 = torch.zeros(B, H), torch.zeros(B, H)
    return xz, rw, pw, h0, c0


def test_lstm_formulas_equal_the_plain_versions_count():
    """K1's and K2's formula is the counter's count of their plain
    recurrences, K3's of its plain reverse sweep."""
    xz, rw, pw, h0, c0 = _lstm()
    T, B, H = xz.shape[0], xz.shape[1], rw.shape[0]
    assert counted(fl.lstm_recurrence_plain, xz, rw, pw, h0, c0) \
        == fl.lstm_recurrence_flops(T, B, H)
    assert counted(fl.lstm_fwd_train_plain, xz, rw, pw, h0, c0) \
        == fl.lstm_recurrence_flops(T, B, H)
    hs, gates, cs = fl.lstm_fwd_train_plain(xz, rw, pw, h0, c0)
    c_prev = torch.cat([c0[None], cs[:-1]])
    assert counted(fl.lstm_bwd_plain, hs, gates, cs, c_prev, rw, pw, h0,
                   c0) == fl.lstm_bwd_flops(T, B, H)
    # the training function: K2, K3 and the dRW product outside them
    xg, rg = xz.clone().requires_grad_(), rw.clone().requires_grad_()

    def step():
        fl.lstm_recurrence(xg, rg, pw, h0, c0)[0].sum().backward()
    assert counted(step) == (fl.lstm_recurrence_flops(T, B, H)
                             + fl.lstm_bwd_flops(T, B, H)
                             + 2 * T * B * H * 4 * H)


def test_kernel_flops_reach_the_step_count_when_a_kernel_reports():
    """What a wrapper reports while a step is counted adds to the count
    (the card's path, where the counter sees no kernel)."""
    net = MultiLayerNetwork(small_mlp(), device="cpu").init()
    ds = small_batch()
    base = cost._count_step(net, ds)[0]
    real = net.compute_gradient_and_score

    def reporting(batch):
        steprecord.note_launch("flash_attn_fwd", "kernel", 1234)
        steprecord.note_launch("flash_attn_fwd", "plain", 99)
        return real(batch)
    net.compute_gradient_and_score = reporting
    assert cost._count_step(net, ds)[0] == base + 1234
    steprecord.note_launch("flash_attn_fwd", "kernel", 1)  # nothing counting


# ----------------------------------------------- the count of whole nets

def gpt_batch(B, T=16, V=13, seed=0):
    r = np.random.default_rng(seed)
    idx = r.integers(0, V, (B, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return DataSet(eye[idx[:, :-1]], eye[idx[:, 1:]])


@pytest.mark.parametrize("kind", ["gpt", "char_rnn"])
def test_step_count_is_linear_in_the_batch(kind):
    """The GPT's (flash attention) and the char-RNN's (the LSTM
    recurrence) count at 4 rows is twice that at 2: the card's [32, ...]
    count is 16 times its CPU twin's at [2, ...]."""
    if kind == "gpt":
        net = ComputationGraph(gpt_decoder(13, 16, 32, 2, 2),
                               device="cpu").init()
    else:
        net = MultiLayerNetwork(char_rnn_lstm(13, 16, 2, tbptt_length=8),
                                device="cpu").init()
    small = net.cost_analysis(gpt_batch(2))["flops_per_step"]
    large = net.cost_analysis(gpt_batch(4))["flops_per_step"]
    assert large == 2 * small


# --------------------------------------------- cost_analysis changes nothing

def small_mlp(seed=11):
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater("adam", learning_rate=1e-2).weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=32, activation="relu", dropout=0.5))
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="mcxent", dropout=0.8))
            .set_input_type(InputType.feed_forward(16)).build())


def small_batch(rows=8, seed=2):
    r = np.random.default_rng(seed)
    return DataSet(r.normal(size=(rows, 16)).astype(np.float32),
                   np.eye(4, dtype=np.float32)[r.integers(0, 4, rows)])


def snapshot(net):
    return ([t.clone() for t in tree_leaves(net.params)],
            [t.clone() for t in tree_leaves(net.opt_state)
             if isinstance(t, torch.Tensor)],
            [t.clone() for t in tree_leaves(net.states)],
            net.iteration_count, net._rng.get_state().clone())


def test_cost_analysis_leaves_the_net_bitwise():
    """After ``cost_analysis`` the net's params, updater state, layer
    states, iteration count and dropout stream are what they were, and
    its next ``fit_batch`` (dropout on) loses bitwise what a twin's
    does."""
    ds = small_batch()
    net, twin = (MultiLayerNetwork(small_mlp(), device="cpu").init()
                 for _ in range(2))
    for n in (net, twin):
        n.fit_batch(ds)
    before = snapshot(net)
    net.cost_analysis(small_batch(seed=3))
    after = snapshot(net)
    for a, b in zip(before[:3], after[:3]):
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert before[3] == after[3]
    assert torch.equal(before[4], after[4])
    assert float(net.fit_batch(ds)).hex() == float(twin.fit_batch(ds)).hex()
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(net.params), tree_leaves(twin.params)))
