"""shardcheck's fixtures (the SC family of the JAX package's
``analysis/fixtures.py``): recorded step programs at dp = 2.

Each maker returns ``(StepProgram, check_kwargs)``. The known-bad steps
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
