"""shardcheck: static analysis of the port's recorded step programs (the
JAX package's ``analysis/shardcheck.py``).

The JAX package lowers a jitted step and reads the compiled program: its
collectives, the dtypes of its dots, its donation aliases, its host
callbacks. A PyTorch step has no program to lower without running it. So
here the "step program" is a **record of one real step**: the step runs
once on the state it would run on, a ``TorchDispatchMode`` and the port's
own hooks note what it did, and the state is then put back bit for bit
(:class:`StepSnapshot`), so the next real step is the one an unchecked
twin takes. A :class:`StepProgram` is plain data that round-trips through
JSON:

- ``ops``: every aten op the step dispatched (the autograd backward
  included): its name, its inputs' and outputs' dtypes and shapes, the
  microbatch it ran in, and which state leaves it read;
- ``collectives``: every ``torch.distributed`` collective, in order, as
  ``parallel/mesh._collective`` reports it (kind, mesh axis, group size,
  dtype, element count, microbatch);
- ``kernel_sites``: each hand-written kernel call, K1-K6, as its wrapper
  reports it (``impl`` "kernel" on the card, "plain" where the wrapper
  ran the plain version on CPU tensors; the record has the same shape on
  both devices);
- ``host_reads``: ``aten._local_scalar_dense`` (``.item()``, ``float(t)``,
  ``bool(t)``) and device-to-host copies inside the window;
- ``state``: each state leaf's storage before and after the step, and its
  dtype after (the params, the updater state, ZeRO's gradient anchor, a
  decode step's KV cache or page pool);
- ``microbatches`` and ``updates``: the accumulation microbatches and the
  optimizer updates the window ran.

Rules (the JAX package's ids, names and severities; what each reads in
the record):

- SC001 full-grad-allreduce (error): under zero1/zero2, a data-axis
  all-reduce outside the accumulation loop at least as large as the
  largest param leaf: the gradient went to every rank whole and the
  reduce-scatter the mode promises never formed.
- SC002 collective-inventory (info; warning): the census of collectives
  and their ring-model bytes; under zero1/zero2, more full-size param
  all-gathers than param leaves. The port packs every leaf into one
  ``(dp, row)`` buffer (``parallel/trainer.py``), so its step makes one
  param gather where the JAX program makes one a leaf.
- SC003 scan-body-repartition (error): an all-gather (or all-to-all) of
  more than ``max(2, dp)`` elements inside a microbatch of an
  accumulating zero step: weights re-gathered per microbatch. The
  per-microbatch gradient reductions and batch norm's global statistics
  (all-reduces) are the contract's expected traffic.
- SC004 precision-boundary (error): under a mixed policy, no product
  (``mm``/``bmm``/``addmm``/``linear``/``convolution``) and no kernel site
  in the half dtype, or params / updater state / loss leaving the step in
  half; under the fp32 preset, an op-and-dtype signature that differs
  from the step of the net built with no policy.
- SC005 donation-dropped (error): a param, updater or anchor leaf whose
  storage the step replaced. The port updates in place; JAX's donation
  is the storage identity here.
- SC006 host-transfer (error): a host read inside the step. A
  collective's own transport is the collective's: gloo stages its
  collectives on CUDA tensors through host memory inside the backend,
  and the port stages gloo's point-to-point ops itself
  (``parallel/mesh._shift``, ``_post``, ``_take``). Those staging copies
  are recorded as ordinary ops tagged ``host_staged`` (the copy that
  made a buffer the collective was handed, and the copy that reads one
  back), counted in SC002's census and reported by SC006 as info, not
  as reads of the step.
- SC007 comm-bytes-calibration (info / warning): :func:`program_comm_bytes`
  against ``profiling/cost.dp_comm_bytes_per_update`` times the updates
  the window ran. The record counts every microbatch's collectives, so
  the gate holds on the accumulation path too.
- SC008 sp-ring-absent (error): an sp > 1 claim with no point-to-point
  shift on the sp axis.
- SC009 kv-cache-not-donated (error): a decode step whose KV cache leaves
  lost their storage, or that copied a whole cache leaf.
- SC010 paged-kv-indirection (error): a paged decode step with fewer
  page-table gathers (``nn/layers/attention.gather_kv_pages``: an index
  op reading a pool leaf) than pool leaves, or a pool leaf replaced or
  copied whole.

Entry points: :func:`record_step_program` (a step function -> a
:class:`StepProgram`), :func:`check_step_program` (a program and the
layout it claims -> findings), :func:`program_comm_bytes`,
``net.shardcheck(batch)`` on both containers (``nn/netcommon``),
``trainer.shardcheck(batch)`` on ``ParallelTrainer``, ``ParallelWrapper``
and ``EarlyStoppingParallelTrainer``, and the decode seam
``keras/generation.StepRunner.step_program``. The command line:

    python -m deeplearning4j_tpu_torch.analysis.shardcheck --self-check
    python -m deeplearning4j_tpu_torch.analysis.shardcheck --contracts
    python -m deeplearning4j_tpu_torch.analysis.shardcheck program.json \\
        --wus zero1 --dp 2 [--accum K] [--param-count N] [--precision bf16]
    python -m deeplearning4j_tpu_torch.analysis.shardcheck --list-rules

``--self-check`` and ``--contracts`` start two gloo ranks of this module
(both on the card, and an error without one; on the CPU with ``--device
cpu``) and run the fixtures of ``analysis/fixtures.py`` there. The hooks
cost one list test when no record is open.
"""

from __future__ import annotations

import copy
import json
from collections import Counter
from dataclasses import asdict, dataclass, field
from math import ceil
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu_torch.analysis import steprecord
from deeplearning4j_tpu_torch.analysis.findings import Finding, Severity
from deeplearning4j_tpu_torch.profiling.cost import ring_bytes

RULES: Dict[str, Tuple[str, str]] = {
    "SC001": ("full-grad-allreduce",
              "zero1/zero2 update path all-reduces a param-sized gradient "
              "over the data axis (no reduce-scatter layout formed)"),
    "SC002": ("collective-inventory",
              "per-step collective census; under zero1/zero2, more "
              "full-size param all-gathers than param leaves"),
    "SC003": ("scan-body-repartition",
              "all-gather inside a microbatch of the gradient-accumulation "
              "loop (sharded weights re-gathered per microbatch)"),
    "SC004": ("precision-boundary",
              "mixed policy without half-precision compute / half "
              "dtypes crossing the master boundary; fp32 preset not "
              "op-and-dtype-identical to the pre-policy step"),
    "SC005": ("donation-dropped",
              "a param / updater-state / anchor leaf replaced out of "
              "place by the step (2x param memory)"),
    "SC006": ("host-transfer",
              "host read (item / device-to-host copy) inside the step"),
    "SC007": ("comm-bytes-calibration",
              "recorded collective bytes vs the cost-model prediction "
              "(tolerance-gated calibration metric)"),
    "SC008": ("sp-ring-absent",
              "trainer claims sp>1 sequence parallelism but the step "
              "ran no point-to-point shift on the sp axis — the ring "
              "attention never formed"),
    "SC009": ("kv-cache-not-donated",
              "decode step claiming an in-place KV cache replaced or "
              "copied a cache buffer — every decode step copies the "
              "whole cache instead of updating it in place"),
    "SC010": ("paged-kv-indirection",
              "decode step claiming a block-paged KV pool either read no "
              "pool through the page table (a dense cache path ran "
              "instead) or replaced / copied the pool (2x resident pool "
              "memory plus a full-pool copy per token)"),
}

#: severity when the rule FIRES as a defect (SC002/SC007 also emit
#: informational findings)
RULE_SEVERITY = {
    "SC001": Severity.ERROR,
    "SC002": Severity.WARNING,
    "SC003": Severity.ERROR,
    "SC004": Severity.ERROR,
    "SC005": Severity.ERROR,
    "SC006": Severity.ERROR,
    "SC007": Severity.WARNING,
    "SC008": Severity.ERROR,
    "SC009": Severity.ERROR,
    "SC010": Severity.ERROR,
}

#: default SC007 gate: |recorded - predicted| / predicted above this warns
COMM_BYTES_TOLERANCE = 0.25

#: SC001 ignores all-reduces below this element count (a loss, a
#: sentinel's flag, a near-scalar leaf): the HBM / comm contract the rule
#: protects lives in the large leaves
SC001_MIN_GRAD_ELEMS = 16

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_SHORT = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}

#: the K-names of the hand-written kernels, by wrapper
KERNELS = {"lstm_fwd_infer": "K1", "lstm_fwd_train": "K2",
           "lstm_bwd": "K3", "flash_attn_fwd": "K4",
           "flash_attn_dq": "K5", "flash_attn_dkv": "K6"}

#: the ops whose result dtype says what precision a product ran in
DOT_OPS = ("mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv",
           "dot", "linear", "matmul", "convolution", "_convolution",
           "convolution_backward")

#: ops that copy their input whole (SC009 / SC010's full-cache copy; a
#: ``.contiguous()`` or ``.to()`` reaches the dispatcher as one of them)
_COPY_OPS = ("clone", "_to_copy", "cat", "_copy_from")

#: index ops through which a paged step reads its pool
_GATHER_OPS = ("index", "index_select", "gather")

#: state roles whose storage SC005 holds, and those of a decode step
_UPDATE_ROLES = ("params", "updater", "anchor")
_CACHE_ROLES = ("cache", "pool")


def dtype_name(dtype) -> str:
    """A torch dtype's short name ('f32', 'bf16', 's64', ...)."""
    return _SHORT.get(dtype, str(dtype).replace("torch.", ""))


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

@dataclass
class OpRecord:
    """One aten op of the step (the aten overload's name, e.g.
    ``mm.default``)."""
    name: str
    in_dtypes: List[str]
    in_shapes: List[List[int]]
    out_dtypes: List[str]
    out_shapes: List[List[int]]
    microbatch: Optional[int] = None
    reads: List[int] = field(default_factory=list)   # state leaf indices
    host_staged: bool = False      # a collective's host staging copy

    @property
    def base(self) -> str:
        return self.name.split(".")[0]


@dataclass
class CollectiveOp:
    """One collective with its logical full payload: the reduced tensor of
    an all-reduce, the gathered result of an all-gather, the pre-scatter
    input of a reduce-scatter, the tensor a point-to-point op sends."""
    kind: str
    axis: str
    group_size: int
    dtype: str
    elems: int
    microbatch: Optional[int] = None
    order: int = 0
    in_loop_body: bool = False
    host_staged: bool = False      # sent through host buffers (gloo, C21)

    @property
    def full_bytes(self) -> int:
        return self.elems * DTYPE_BYTES.get(self.dtype, 4)

    def ring_bytes(self) -> int:
        """Per-rank bytes on the standard ring model
        (``profiling/cost.ring_bytes``)."""
        return ring_bytes(self.kind, self.group_size, self.full_bytes)


@dataclass
class KernelSite:
    """One call of a hand-written kernel's wrapper."""
    name: str                      # K1-K6
    impl: str                      # "kernel" | "plain"
    dtypes: List[str]
    shapes: List[List[int]]
    microbatch: Optional[int] = None


@dataclass
class HostRead:
    op: str
    dtype: str
    shape: List[int]
    microbatch: Optional[int] = None
    host_staged: bool = False      # a collective's host staging copy


@dataclass
class StateLeaf:
    """A state leaf's storage before and after the step (``None`` where
    the leaf did not exist on that side) and its dtype after."""
    role: str
    path: str
    shape: List[int]
    dtype: str
    numel: int
    storage_before: Optional[int] = None
    storage_after: Optional[int] = None

    @property
    def kept(self) -> bool:
        return (self.storage_before is not None
                and self.storage_before == self.storage_after)

    @property
    def compared(self) -> bool:
        return (self.storage_before is not None
                and self.storage_after is not None)


@dataclass
class StepProgram:
    """The record of one step (see the module docstring)."""
    ops: List[OpRecord] = field(default_factory=list)
    collectives: List[CollectiveOp] = field(default_factory=list)
    kernel_sites: List[KernelSite] = field(default_factory=list)
    host_reads: List[HostRead] = field(default_factory=list)
    state: List[StateLeaf] = field(default_factory=list)
    boundary: Dict[str, List[str]] = field(default_factory=dict)
    microbatches: int = 1
    updates: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)

    # --------------------------------------------------------- JSON
    _KEYS = ("ops", "collectives", "kernel_sites", "host_reads", "state",
             "boundary", "microbatches", "updates", "meta")

    def to_json(self) -> str:
        d = {k: getattr(self, k) for k in self._KEYS}
        d["ops"] = [[o.name, o.in_dtypes, o.in_shapes, o.out_dtypes,
                     o.out_shapes, o.microbatch, o.reads, o.host_staged]
                    for o in self.ops]
        for k in ("collectives", "kernel_sites", "host_reads", "state"):
            d[k] = [asdict(x) for x in d[k]]
        d["format"] = "dl4j-torch-step-program/v1"
        return json.dumps(d)

    @classmethod
    def from_json(cls, text: str) -> "StepProgram":
        """A program from :meth:`to_json`'s text; ``ValueError`` for text
        that is not one."""
        try:
            d = json.loads(text)
        except (TypeError, ValueError) as e:
            raise ValueError(f"not a step program: {e}") from None
        if not isinstance(d, dict) \
                or d.get("format") != "dl4j-torch-step-program/v1":
            raise ValueError("not a step program: no "
                             "'dl4j-torch-step-program/v1' format tag")
        try:
            return cls(
                ops=[OpRecord(*o) for o in d["ops"]],
                collectives=[CollectiveOp(**c) for c in d["collectives"]],
                kernel_sites=[KernelSite(**k) for k in d["kernel_sites"]],
                host_reads=[HostRead(**h) for h in d["host_reads"]],
                state=[StateLeaf(**s) for s in d["state"]],
                boundary=dict(d["boundary"]),
                microbatches=int(d["microbatches"]),
                updates=int(d["updates"]), meta=dict(d["meta"]))
        except (KeyError, TypeError) as e:
            raise ValueError(f"not a step program: {e!r}") from None

    # ------------------------------------------------------- views
    def dot_dtypes(self) -> Counter:
        """Result dtypes of every product op (mm, bmm, addmm,
        convolution, ...)."""
        return Counter(o.out_dtypes[0] for o in self.ops
                       if o.base in DOT_OPS and o.out_dtypes)

    def kernel_dtypes(self) -> Counter:
        """(kernel, first input dtype) of every kernel site."""
        return Counter((k.name, k.dtypes[0] if k.dtypes else "")
                       for k in self.kernel_sites)

    def kernel_counts(self) -> Counter:
        return Counter(k.name for k in self.kernel_sites)

    def op_signature(self) -> Counter:
        """(op, input dtypes, output dtypes) multiset of the ops and the
        kernel sites: the fp32-preset identity surface."""
        sig = Counter((o.name, tuple(o.in_dtypes), tuple(o.out_dtypes))
                      for o in self.ops)
        sig.update(("kernel:" + k.name, tuple(k.dtypes), ())
                   for k in self.kernel_sites)
        return sig

    def leaves(self, *roles) -> List[StateLeaf]:
        return [s for s in self.state if s.role in roles]

    def saw_backward(self) -> bool:
        """True when the record holds autograd backward ops (the
        dispatch mode reached the backward pass)."""
        return any(o.base.endswith("_backward")
                   or o.base.endswith("_backward_data")
                   for o in self.ops)


# ---------------------------------------------------------------------------
# the recorder (``analysis/steprecord``'s hooks report into it)
# ---------------------------------------------------------------------------

def _tensors(items):
    for x in items:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            for y in x:
                if isinstance(y, torch.Tensor):
                    yield y


def _storage(t: torch.Tensor) -> Optional[int]:
    try:
        ptr = t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return None
    return ptr or None


class _Recorder(steprecord.Listener):
    def __init__(self):
        self.program = StepProgram()
        self.microbatches = 1
        # per op: the storages its inputs and its outputs live in (which
        # state leaf an op read is resolved after the step)
        self.storages: List[Tuple[list, list]] = []
        # the host read each op made, by op index
        self.reads: Dict[int, HostRead] = {}
        # host buffers a collective was staged through, not yet read back
        self.staged: set = set()

    def note_microbatch(self, index: int) -> None:
        self.microbatches = max(self.microbatches, index + 1)

    def note_update(self) -> None:
        self.program.updates += 1

    def note_collective(self, kind, axis, group_size, payload, microbatch,
                        host_buffers) -> None:
        colls = self.program.collectives
        colls.append(CollectiveOp(
            kind=kind, axis=axis or "?", group_size=int(group_size),
            dtype=dtype_name(payload.dtype), elems=int(payload.numel()),
            microbatch=microbatch, order=len(colls),
            host_staged=bool(host_buffers)))
        # the copy that made each buffer ran before the collective
        for ptr in {_storage(t) for t in host_buffers} - {None}:
            self.staged.add(ptr)
            for j in range(len(self.storages) - 1, -1, -1):
                if ptr in self.storages[j][1]:
                    self._tag(j)
                    break

    def note_launch(self, wrapper, impl, flops, tensors, microbatch
                    ) -> None:
        self.program.kernel_sites.append(KernelSite(
            name=KERNELS[wrapper], impl=impl,
            dtypes=[dtype_name(t.dtype) for t in tensors],
            shapes=[list(t.shape) for t in tensors], microbatch=microbatch))

    def _tag(self, j: int) -> None:
        """Op ``j`` is a collective's host staging copy."""
        self.program.ops[j].host_staged = True
        if j in self.reads:
            self.reads[j].host_staged = True

    def op(self, func, args, kwargs, out) -> None:
        ins = list(_tensors(args)) + list(_tensors(kwargs.values()))
        outs = list(_tensors(out if isinstance(out, (list, tuple))
                             else [out]))
        name = func.__name__
        mb = steprecord.current_microbatch()
        in_ptrs = [_storage(t) for t in ins]
        self.storages.append((in_ptrs, [_storage(t) for t in outs]))
        self.program.ops.append(OpRecord(
            name, [dtype_name(t.dtype) for t in ins],
            [list(t.shape) for t in ins],
            [dtype_name(t.dtype) for t in outs],
            [list(t.shape) for t in outs], mb, []))
        base = name.split(".")[0]
        host = None
        if base == "_local_scalar_dense":
            host = ins[0]
        elif base == "_to_copy" and ins and outs:
            if ins[0].device.type != "cpu" and outs[0].device.type == "cpu":
                host = ins[0]
        elif base in ("copy_", "copy") and len(ins) >= 2:
            if ins[0].device.type == "cpu" and ins[1].device.type != "cpu":
                host = ins[1]
        elif base == "_copy_from" and len(ins) >= 2:
            if ins[0].device.type != "cpu" and ins[1].device.type == "cpu":
                host = ins[0]
        j = len(self.program.ops) - 1
        if host is not None:
            self.reads[j] = HostRead(name, dtype_name(host.dtype),
                                     list(host.shape), mb)
            self.program.host_reads.append(self.reads[j])
        # a staged buffer read back (a receive's copy to the device)
        back = self.staged.intersection(in_ptrs)
        if back:
            self.staged -= back
            self._tag(j)


class _OpTap(TorchDispatchMode):
    """Notes every aten op that reaches the dispatcher, forward and
    backward (the autograd engine carries the mode to its threads)."""

    def __init__(self, recorder: _Recorder):
        super().__init__()
        self.recorder = recorder

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.recorder.op(func, args, kwargs, out)
        return out


def _paths(tree, prefix: str = ""):
    """(path, tensor) of every tensor leaf of a dict / list tree."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def _state_leaves(state) -> Dict[str, Tuple[str, torch.Tensor]]:
    out = {}
    for role, tree in (state() if callable(state) else state or {}).items():
        for path, t in _paths(tree):
            out[role + path] = (role, t)
    return out


def _resolve_reads(rec: _Recorder, program: StepProgram) -> None:
    """Each op's ``reads``: the state leaves whose storage an input lives
    in. A leaf there before the step is live throughout it; a leaf the
    step made (a replaced one) counts from the last op that wrote its
    storage without reading it (the allocation; an in-place op reads what
    it writes), so a temporary that held the address earlier is not taken
    for it."""
    alive: Dict[int, int] = {}
    born: Dict[int, Tuple[int, int]] = {}
    for i, leaf in enumerate(program.state):
        if leaf.storage_before is not None:
            alive.setdefault(leaf.storage_before, i)
        if leaf.storage_after not in (None, leaf.storage_before):
            born.setdefault(leaf.storage_after, (i, -1))
    if born:
        for j, (ins, outs) in enumerate(rec.storages):
            for ptr in outs:
                if ptr in born and ptr not in ins:
                    born[ptr] = (born[ptr][0], j)
    for j, (ins, _) in enumerate(rec.storages):
        reads = program.ops[j].reads
        for ptr in ins:
            i = alive.get(ptr)
            if i is None and ptr in born and j > born[ptr][1]:
                i = born[ptr][0]
            if i is not None and i not in reads:
                reads.append(i)


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (list, tuple)):
        for y in x:
            t = _first_tensor(y)
            if t is not None:
                return t
    return None


def record_step_program(fn: Callable, *args, state=None,
                        **kwargs) -> StepProgram:
    """Run ``fn(*args, **kwargs)`` once, as one step, and record it.

    ``state``: ``{role: tree of tensors}`` or a callable returning it,
    read before and after the step (a callable lets the step rebind its
    containers, or hand back the ones it returns); roles "params",
    "updater", "anchor" (SC005), "cache" / "pool" (SC009 / SC010). The
    step's loss is the first tensor ``fn`` returns. Nothing is put back:
    wrap the call in a :class:`StepSnapshot` to leave the state as it
    was."""
    before = _state_leaves(state)
    rec = _Recorder()
    steprecord.RECORDERS.append(rec)
    try:
        with _OpTap(rec):
            result = fn(*args, **kwargs)
    finally:
        steprecord.RECORDERS.remove(rec)
    after = _state_leaves(state)
    program = rec.program
    program.microbatches = rec.microbatches
    for c in program.collectives:
        c.in_loop_body = c.microbatch is not None and rec.microbatches > 1
    for path in list(before) + [p for p in after if p not in before]:
        role, t = after.get(path, before.get(path))
        program.state.append(StateLeaf(
            role=role, path=path, shape=list(t.shape),
            dtype=dtype_name(t.dtype), numel=int(t.numel()),
            storage_before=(_storage(before[path][1]) if path in before
                            else None),
            storage_after=(_storage(after[path][1]) if path in after
                           else None)))
    _resolve_reads(rec, program)
    boundary: Dict[str, List[str]] = {}
    for path, (role, t) in after.items():
        if role in ("params", "updater"):
            boundary.setdefault(role, []).append(dtype_name(t.dtype))
    loss = _first_tensor(result)
    if loss is not None:
        boundary["loss"] = [dtype_name(loss.dtype)]
    program.boundary = boundary
    program.meta = {"torch": torch.__version__,
                    "device": (loss.device.type if loss is not None
                               else "?")}
    return program


# ---------------------------------------------------------------------------
# putting the state back
# ---------------------------------------------------------------------------

class _TreeSnapshot:
    """A dict / list tree as it is now: each container's items and each
    tensor's values, put back in place (the same containers, the same
    tensor objects and storages) by :meth:`restore`."""

    def __init__(self, tree):
        self.tree = tree
        self.containers: List[Tuple[Any, Any]] = []
        self.tensors: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._walk(tree)

    def _walk(self, node) -> None:
        if isinstance(node, dict):
            self.containers.append((node, dict(node)))
            for v in node.values():
                self._walk(v)
        elif isinstance(node, list):
            self.containers.append((node, list(node)))
            for v in node:
                self._walk(v)
        elif isinstance(node, tuple):
            for v in node:
                self._walk(v)
        elif isinstance(node, torch.Tensor):
            self.tensors.append((node, node.detach().clone()))

    @torch.no_grad()
    def restore(self):
        for c, items in self.containers:
            if isinstance(c, dict):
                c.clear()
                c.update(items)
            else:
                c[:] = items
        for t, v in self.tensors:
            t.copy_(v)
        return self.tree


class _Missing:
    pass


#: what a step may change on a container, besides its trees
_NET_ATTRS = ("iteration_count", "epoch_count", "last_batch_size",
              "_score_raw", "last_grads", "last_input", "last_scan_window",
              "listeners", "_rng", "_batch_sum")


class StepSnapshot:
    """Everything a recorded step may change, taken on entry and put back
    bit for bit on exit: for each net its params, layer states (batch
    norm's running statistics) and updater state (the containers and the
    tensors, in place), its step counts, score, last batch size,
    gradients and input, its dropout generator's state, its sentinel's
    pending flags and skip count; for ``owner`` (a trainer or wrapper)
    the attributes named in ``owner_attrs`` (ZeRO's gradient anchor, the
    derived dropout stream, the training stats); and the global CPU and
    CUDA generators. The nets hear no listener inside the block."""

    def __init__(self, nets, owner=None, owner_attrs: Sequence[str] = ()):
        self.nets = list(nets)
        self.owner = owner
        self.owner_attrs = tuple(owner_attrs)

    @staticmethod
    def _take(value):
        if isinstance(value, torch.Tensor):
            return ("tensor", value, value.detach().clone())
        if isinstance(value, torch.Generator):
            return ("gen", value, value.get_state())
        if hasattr(value, "phases"):      # optimize.TrainingStats
            return ("stats", value, copy.deepcopy(vars(value)))
        return ("value", value, None)

    @staticmethod
    @torch.no_grad()
    def _give(kind, value, saved):
        if kind == "tensor":
            value.copy_(saved)
        elif kind == "gen":
            value.set_state(saved)
        elif kind == "stats":
            vars(value).clear()
            vars(value).update(saved)
        return value

    def __enter__(self) -> "StepSnapshot":
        self._nets = []
        for net in self.nets:
            trees = {a: _TreeSnapshot(getattr(net, a))
                     for a in ("params", "states", "opt_state")}
            attrs = {a: self._take(getattr(net, a, _Missing))
                     for a in _NET_ATTRS}
            sentinel = getattr(net, "_sentinel", None)
            sent = None
            if sentinel is not None and hasattr(sentinel, "_pending"):
                sent = (list(sentinel._pending), sentinel._skipped)
            self._nets.append((net, trees, attrs, sent))
            net.listeners = []
        self._owner = {a: self._take(getattr(self.owner, a, _Missing))
                       for a in self.owner_attrs}
        self._cpu_rng = torch.get_rng_state()
        self._cuda_rng = (torch.cuda.get_rng_state_all()
                          if torch.cuda.is_initialized() else None)
        return self

    def __exit__(self, *exc) -> None:
        for net, trees, attrs, sent in self._nets:
            for a, snap in trees.items():
                setattr(net, a, snap.restore())
            for a, (kind, value, saved) in attrs.items():
                if value is _Missing:
                    if a in vars(net):
                        delattr(net, a)
                else:
                    setattr(net, a, self._give(kind, value, saved))
            if sent is not None:
                net._sentinel._pending.clear()
                net._sentinel._pending.extend(sent[0])
                net._sentinel._skipped = sent[1]
        for a, (kind, value, saved) in self._owner.items():
            if value is not _Missing:
                setattr(self.owner, a, self._give(kind, value, saved))
        torch.set_rng_state(self._cpu_rng)
        if self._cuda_rng is not None:
            torch.cuda.set_rng_state_all(self._cuda_rng)


# ---------------------------------------------------------------------------
# comm bytes
# ---------------------------------------------------------------------------

def program_comm_bytes(program: StepProgram, dp: Optional[int] = None
                       ) -> int:
    """Per-rank collective bytes of the recorded step on the ring model
    (every microbatch's collectives counted): the number
    ``cost_analysis()["comm_bytes_hlo"]`` carries and SC007 gates against
    the cost model. ``dp`` stands in for the group size of a collective
    recorded without one."""
    total = 0
    for c in program.collectives:
        if c.group_size <= 0 and dp:
            c = copy.copy(c)
            c.group_size = int(dp)
        total += c.ring_bytes()
    return total


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def _fmt(dtype: str, elems: int) -> str:
    return f"{dtype}[{elems}]"


def _wus_mode(weight_update_sharding) -> str:
    if weight_update_sharding is None:
        return "off"
    return str(getattr(weight_update_sharding, "mode",
                       weight_update_sharding)).lower()


def _precision_compute(precision) -> str:
    """The compute dtype of a precision spec (None / preset name /
    ``PrecisionPolicy``)."""
    from deeplearning4j_tpu_torch.analysis.graphcheck import (
        _precision_fields,
    )
    compute, _ = _precision_fields(precision)
    return compute or "float32"


_HALF_SHORT = {"bfloat16": "bf16", "bf16": "bf16",
               "float16": "f16", "fp16": "f16", "half": "f16"}

_DATA_AXES = ("data", "replicas", "?")


def _check_sc001(findings, program: StepProgram, wus: str, dp: int,
                 leaf_sizes: Optional[Sequence[int]]) -> None:
    if wus not in ("zero1", "zero2"):
        return
    floor = SC001_MIN_GRAD_ELEMS
    if leaf_sizes:
        floor = max(floor, max(int(s) for s in leaf_sizes))
    for c in program.collectives:
        if (c.kind != "all-reduce" or c.in_loop_body
                or c.axis not in _DATA_AXES or c.elems < floor):
            continue
        findings.append(Finding(
            "SC001", Severity.ERROR, f"collective #{c.order} ({c.axis})",
            f"{wus} update path all-reduces {_fmt(c.dtype, c.elems)} over "
            f"the {c.axis} axis at full size (the largest param leaf has "
            f"{floor} elements) — the reduce-scatter layout never formed, "
            "so every rank still holds and applies the full update and "
            "the updater-memory / comm wins are gone",
            "pack the gradient into the (dp, row) layout and "
            "reduce-scatter it (parallel/trainer.py _reduce)"))
        return


def _param_gather_sizes(leaf_sizes: Sequence[int], dp: int) -> set:
    """Element counts of a full-size param gather: one leaf's padded
    ``(dp, chunk)`` view, or the packed ``(dp, row)`` buffer of them all."""
    chunks = [ceil(int(s) / dp) for s in leaf_sizes]
    return {dp * c for c in chunks} | {dp * sum(chunks)}


def _check_sc002(findings, program: StepProgram, wus: str, dp: int,
                 leaf_sizes: Optional[Sequence[int]]) -> None:
    colls = program.collectives
    if colls:
        kinds = Counter(c.kind for c in colls)
        in_body = sum(1 for c in colls if c.in_loop_body)
        staged = sum(1 for c in colls if c.host_staged)
        total = program_comm_bytes(program)
        census = ", ".join(f"{n}x {k}" for k, n in sorted(kinds.items()))
        findings.append(Finding(
            "SC002", Severity.INFO, "<program>",
            f"collectives per step: {census}"
            + (f" ({in_body} inside microbatches)" if in_body else "")
            + (f" ({staged} staged through host buffers)" if staged
               else "")
            + f"; ~{total:,} ring-model bytes/rank",
            ""))
    if wus not in ("zero1", "zero2") or not leaf_sizes or dp < 2:
        return
    sizes = _param_gather_sizes(leaf_sizes, dp)
    gathers = [c for c in colls if c.kind == "all-gather"
               and not c.in_loop_body and c.elems in sizes]
    if len(gathers) > len(leaf_sizes):
        findings.append(Finding(
            "SC002", Severity.WARNING, "<program>",
            f"{len(gathers)} full-size param all-gathers for "
            f"{len(leaf_sizes)} param leaves — under {wus} the single "
            "param all-gather is the only full-size collective the "
            "update should ship",
            "look for a second gather of the updated rows, or a "
            "replicated copy of sharded state rebuilt mid-step"))


def _check_sc003(findings, program: StepProgram, check_scan: bool,
                 dp: int) -> None:
    if not check_scan:
        return
    for c in program.collectives:
        if not c.in_loop_body or c.kind not in ("all-gather",
                                                "all-to-all"):
            continue
        if c.elems <= max(2, dp):
            continue
        findings.append(Finding(
            "SC003", Severity.ERROR,
            f"collective #{c.order} in microbatch {c.microbatch}",
            f"{c.kind} of {_fmt(c.dtype, c.elems)} INSIDE microbatch "
            f"{c.microbatch} of the gradient-accumulation loop — sharded "
            "state is re-gathered per MICROBATCH, so the per-microbatch "
            "anchor of the update layout is gone",
            "gather the params once an update, after the loop "
            "(parallel/trainer.py _apply)"))
        return


def _check_sc004(findings, program: StepProgram, precision,
                 baseline: Optional[StepProgram]) -> None:
    compute = _precision_compute(precision)
    half = _HALF_SHORT.get(compute)
    dots = program.dot_dtypes()
    kernels = Counter(dt for (_, dt) in program.kernel_dtypes().elements())
    compute_dtypes = dots + kernels
    if half is not None:
        if compute_dtypes and not any(dt == half for dt in compute_dtypes):
            findings.append(Finding(
                "SC004", Severity.ERROR, f"compute={compute}",
                f"policy declares {compute} compute but no product and no "
                f"kernel in the step runs in {half} (dtypes: "
                f"{dict(compute_dtypes)}) — the step-boundary casts were "
                "gated out and the step runs full precision",
                "check the PrecisionPolicy reaches the step (trainer "
                "precision= / conf.training.precision)"))
        bad = [(role, dt) for role in ("params", "updater", "loss")
               for dt in program.boundary.get(role, ())
               if dt in ("bf16", "f16")]
        if bad:
            role, dt = bad[0]
            findings.append(Finding(
                "SC004", Severity.ERROR, f"boundary {role}",
                f"master weights / updater state / loss leave the step as "
                f"{dt} ({len(bad)} leaf(s); first: {role}) — masters must "
                "stay fp32 (checkpoints persist fp32; half masters destroy "
                "the restore-equals-unbroken-run guarantee)",
                "cast gradients back to the params' dtype before the "
                "update (nn/updater.precision_value_and_grad)"))
        return
    if baseline is not None:
        a, b = program.op_signature(), baseline.op_signature()
        if a != b:
            diff = (a - b) + (b - a)
            sample = dict(list(diff.items())[:4])
            findings.append(Finding(
                "SC004", Severity.ERROR, "fp32-preset",
                "fp32 preset is NOT op-and-dtype-identical to the "
                f"pre-policy step ({sum(diff.values())} op(s) differ, "
                f"e.g. {sample}) — a cast leaked through the gate and the "
                "step is a different program than the parity tests "
                "proved",
                "the fp32 preset must gate every cast out "
                "(PrecisionPolicy.mixed False -> plain value_and_grad)"))
    elif any(dt in ("bf16", "f16") for dt in compute_dtypes):
        findings.append(Finding(
            "SC004", Severity.ERROR, "fp32-policy",
            f"policy is fp32 but the step computes in half precision "
            f"(dtypes: {dict(compute_dtypes)})",
            "a cast escaped the fp32 gate — find the stray .to()"))


def _check_sc005(findings, program: StepProgram,
                 expect_donation: Optional[bool]) -> None:
    leaves = [s for s in program.leaves(*_UPDATE_ROLES) if s.compared]
    replaced = [s for s in leaves if not s.kept]
    if expect_donation:
        if not leaves:
            findings.append(Finding(
                "SC005", Severity.ERROR, "<state>",
                "step was expected to update its state in place but the "
                "record carries no param / updater leaf to hold it to",
                "record the step with state= naming its params and "
                "updater state"))
        elif replaced:
            findings.append(Finding(
                "SC005", Severity.ERROR, replaced[0].path,
                f"the step replaced {len(replaced)} of {len(leaves)} "
                f"state leaves out of place (first: {replaced[0].path}, "
                f"{replaced[0].dtype}{replaced[0].shape}) — old params / "
                "updater state stay alive across every update: 2x peak "
                "param memory, and whatever holds the old tensors (a CUDA "
                "graph, a trainer's views) reads stale values",
                "update the leaves in place (nn/updater.compute_updates "
                "writes with add_ / copy_)"))
    elif expect_donation is None and replaced:
        findings.append(Finding(
            "SC005", Severity.WARNING, replaced[0].path,
            f"{len(replaced)} state leaf(s) replaced out of place by the "
            "step", "see SC005"))


def _check_sc006(findings, program: StepProgram) -> None:
    hits = [h for h in program.host_reads if not h.host_staged]
    staged = len(program.host_reads) - len(hits)
    if staged:
        findings.append(Finding(
            "SC006", Severity.INFO, "<program>",
            f"{staged} host copies are the transport of collectives "
            "staged through host buffers (gloo's point-to-point ops on "
            "CUDA tensors, ROADMAP C21), not reads of the step", ""))
    if hits:
        h = hits[0]
        findings.append(Finding(
            "SC006", Severity.ERROR, f"{h.op}",
            f"host read inside the step: {h.op} of {h.dtype}{h.shape}"
            + (f" (+{len(hits) - 1} more)" if len(hits) > 1 else "")
            + " — every step pays a device-to-host round trip "
            "serialized with the device work",
            "keep the value on the device (a device scalar, a flag the "
            "host drains later) or read it after the step"))


def _check_sc008(findings, program: StepProgram, sp: int) -> None:
    if sp <= 1:
        return
    if any(c.kind == "collective-permute" and c.axis == "sp"
           for c in program.collectives):
        return
    findings.append(Finding(
        "SC008", Severity.ERROR, f"sp={sp}",
        "trainer claims sp-axis sequence parallelism but the step ran no "
        "point-to-point shift on the sp axis — the ring attention never "
        "formed",
        "check the model has a SelfAttentionLayer with "
        "sequence_parallel=True, the sequence length divides the sp axis "
        "and the batch divides the data axis (the layer declines the ring "
        "otherwise); or drop the sp axis"))


def _full_copies(program: StepProgram, leaves: List[StateLeaf]) -> list:
    """Ops that copied one of ``leaves`` whole."""
    index = {id(s): i for i, s in enumerate(program.state)}
    wanted = {index[id(s)]: s for s in leaves}
    hits = []
    for o in program.ops:
        if o.base not in _COPY_OPS:
            continue
        for i in o.reads:
            s = wanted.get(i)
            if s is not None and any(
                    _numel(sh) >= s.numel for sh in o.out_shapes):
                hits.append((o, s))
    return hits


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _check_sc009(findings, program: StepProgram,
                 expect_cache_alias: Optional[int]) -> None:
    if not expect_cache_alias or expect_cache_alias < 1:
        return
    leaves = program.leaves(*_CACHE_ROLES)
    kept = [s for s in leaves if s.kept]
    copies = _full_copies(program, leaves)
    if len(kept) >= expect_cache_alias and not copies:
        return
    if len(kept) < expect_cache_alias:
        what = (f"only {len(kept)} of them kept their storage "
                f"({len(leaves)} recorded)")
    else:
        o, s = copies[0]
        what = f"{o.name} copied {s.path} whole"
    findings.append(Finding(
        "SC009", Severity.ERROR, "<decode>",
        f"decode step claims {expect_cache_alias} KV-cache buffers "
        f"donated (updated in place) but {what} — every decode step "
        "copies the "
        "cache instead of writing its one new token in place",
        "write the token with an in-place index_put_ "
        "(nn/layers/attention.decode_step) and return the same tensors"))


def _check_sc010(findings, program: StepProgram,
                 expect_paged_gather: Optional[int]) -> None:
    if not expect_paged_gather or expect_paged_gather < 1:
        return
    leaves = program.leaves(*_CACHE_ROLES)
    index = {id(s): i for i, s in enumerate(program.state)}
    ids = {index[id(s)] for s in leaves}
    gathers = [o for o in program.ops
               if o.base in _GATHER_OPS and any(i in ids for i in o.reads)]
    if len(gathers) < expect_paged_gather:
        findings.append(Finding(
            "SC010", Severity.ERROR, "<decode>",
            f"decode step claims a block-paged KV pool with "
            f"{expect_paged_gather} leaf buffers but only {len(gathers)} "
            "op(s) read a pool leaf through an index — the page-table "
            "indirection never formed; this is a dense cache step wearing "
            "a paged signature, so page eviction and prefix sharing cannot "
            "be in effect",
            "build the step with paged_decode_fn (nn/graph.py): the cache "
            "read must be gather_kv_pages(pool, page_table)"))
        return
    kept = [s for s in leaves if s.kept]
    copies = _full_copies(program, leaves)
    if len(kept) >= expect_paged_gather and not copies:
        return
    if len(kept) < expect_paged_gather:
        what = (f"only {len(kept)} pool leaf(s) kept their storage "
                "through the indirection")
    else:
        o, s = copies[0]
        what = f"{o.name} copied the pool leaf {s.path} whole"
    findings.append(Finding(
        "SC010", Severity.ERROR, "<decode>",
        f"paged decode step claims {expect_paged_gather} pool buffers "
        f"donated (updated in place) but {what} — the pool is resident "
        "twice and copied once per token",
        "scatter the new token into the same pool tensors in place "
        "(nn/layers/attention.scatter_kv_token)"))


def _check_sc007(findings, program: StepProgram, wus: str, dp: int,
                 gradient_accumulation: int, param_count: Optional[int],
                 tolerance: float) -> None:
    if not param_count or dp < 2:
        return
    from deeplearning4j_tpu_torch.profiling.cost import (
        dp_comm_bytes_per_update,
    )
    recorded = program_comm_bytes(program, dp)
    updates = max(1, program.updates)
    predicted = updates * dp_comm_bytes_per_update(
        param_count, dp, 4, gradient_accumulation, wus)
    if not predicted:
        return
    delta = (recorded - predicted) / predicted
    loc = f"dp={dp},{wus},k={gradient_accumulation}"
    if updates > 1:
        loc += f",updates={updates}"
    if abs(delta) > tolerance:
        findings.append(Finding(
            "SC007", Severity.WARNING, loc,
            f"recorded collective bytes {recorded:,}/rank vs cost-model "
            f"prediction {predicted:,} — {delta:+.0%} is outside the "
            f"{tolerance:.0%} tolerance; either the step ships "
            "collectives the layout does not need or "
            "profiling/cost.dp_comm_bytes_per_update mis-models this "
            "config (the autotuner calibrates on this gap)",
            "read the SC002 inventory to see which collective is "
            "unaccounted for"))
    else:
        findings.append(Finding(
            "SC007", Severity.INFO, loc,
            f"comm bytes: recorded {recorded:,}/rank vs predicted "
            f"{predicted:,} ({delta:+.0%})", ""))


def check_step_program(program: StepProgram, *,
                       weight_update_sharding="off",
                       dp: int = 1,
                       gradient_accumulation: int = 1,
                       sp: int = 1,
                       precision=None,
                       baseline: Optional[StepProgram] = None,
                       expect_donation: Optional[bool] = None,
                       param_leaf_sizes: Optional[Sequence[int]] = None,
                       param_count: Optional[int] = None,
                       cost_tolerance: float = COMM_BYTES_TOLERANCE,
                       check_scan: Optional[bool] = None,
                       check_cost: bool = True,
                       expect_cache_alias: Optional[int] = None,
                       expect_paged_gather: Optional[int] = None,
                       ) -> List[Finding]:
    """Run every SC rule over one recorded step.

    The keyword context declares what the step CLAIMS to be, as in the
    JAX package: the layout (``weight_update_sharding`` / ``dp`` /
    ``gradient_accumulation`` / ``sp``), the precision policy (with
    ``baseline`` as the pre-policy step for the fp32 identity check),
    whether the state is updated in place (``expect_donation``), the
    param leaf sizes the collective census is reconciled against, and a
    decode step's cache / pool leaf count. No execution."""
    findings: List[Finding] = []
    wus = _wus_mode(weight_update_sharding)
    dp = int(dp or 1)
    sp = int(sp or 1)
    if param_leaf_sizes and param_count is None:
        param_count = sum(int(s) for s in param_leaf_sizes)
    if check_scan is None:
        check_scan = wus in ("zero1", "zero2") and gradient_accumulation > 1
    # an sp mesh under ZeRO sums the gradient over the sp axis first (a
    # full-size all-reduce by design) and adds the ring's traffic: the
    # dp reduce-scatter contract (SC001) and the dp ring model (SC007)
    # do not describe it; SC008 proves the sp claim's own contract
    sp_unconstrained = sp > 1 and wus in ("zero1", "zero2")
    layout = "off" if sp_unconstrained else wus
    _check_sc001(findings, program, layout, dp, param_leaf_sizes)
    _check_sc002(findings, program, layout, dp, param_leaf_sizes)
    _check_sc003(findings, program, check_scan and not sp_unconstrained,
                 dp)
    _check_sc004(findings, program, precision, baseline)
    _check_sc005(findings, program, expect_donation)
    _check_sc006(findings, program)
    _check_sc008(findings, program, sp)
    _check_sc009(findings, program, expect_cache_alias)
    _check_sc010(findings, program, expect_paged_gather)
    if check_cost and sp == 1:
        _check_sc007(findings, program, wus, dp, gradient_accumulation,
                     param_count, cost_tolerance)
    return findings


# ---------------------------------------------------------------------------
# convenience: record + check a container's step
# ---------------------------------------------------------------------------

def param_leaf_sizes(params) -> List[int]:
    """Element count of each param leaf, in ``tree_leaves`` order."""
    from deeplearning4j_tpu_torch.nn.updater import tree_leaves
    return [int(t.numel()) for t in tree_leaves(params)]


def net_state(net) -> dict:
    """The state leaves a container's step updates in place."""
    return {"params": net.params, "updater": net.opt_state}


def net_step_window(net, batch):
    """The container's own step on ``batch`` without its bookkeeping (the
    step ``fit_batch`` runs): an SGD-family step, the tBPTT windows, or
    the line-search solver's run. Returns the loss."""
    from deeplearning4j_tpu_torch.nn.netcommon import SGD_ALGOS
    if net.conf.training.optimization_algo not in SGD_ALGOS:
        from deeplearning4j_tpu_torch.optimize.solvers import (
            solver_fit_batch,
        )
        return solver_fit_batch(net, batch)
    if net._tbptt_applies(batch):
        return net._fit_tbptt(batch)
    return net._train_batch(batch)[0]


def net_step_program(net, batch) -> StepProgram:
    """Record a container's own training step on ``batch`` and put the
    net back as it was — the seam ``net.shardcheck`` uses."""
    net._check_init()
    with StepSnapshot([net]):
        return record_step_program(net_step_window, net, batch,
                                   state=lambda: net_state(net))


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def _significant(findings):
    """Findings above INFO — the self-check / contract 'dirty' bar."""
    return [f for f in findings if f.severity != Severity.INFO]


def self_check(report=print, device=None) -> int:
    """Every SC rule fires on its known-bad fixture and every known-good
    fixture is silent above INFO (needs a group of two ranks; the
    fixtures run on ``device``, ``None`` meaning the card)."""
    import time
    from deeplearning4j_tpu_torch.analysis.fixtures import (
        SC_KNOWN_BAD, SC_KNOWN_GOOD,
    )
    ok = True
    for name, rule, make in SC_KNOWN_BAD:
        t0 = time.perf_counter()
        program, kwargs = make(device)
        rules = {f.rule for f in check_step_program(program, **kwargs)}
        dt = time.perf_counter() - t0
        if rule in rules:
            report(f"  known-bad  {name:<30} fired {rule} ({dt:.1f}s, ok)")
        else:
            ok = False
            report(f"  known-bad  {name:<30} FAILED: wanted {rule}, "
                   f"got {sorted(rules) or 'no findings'}")
    for name, make in SC_KNOWN_GOOD:
        t0 = time.perf_counter()
        program, kwargs = make(device)
        bad = _significant(check_step_program(program, **kwargs))
        dt = time.perf_counter() - t0
        if bad:
            ok = False
            report(f"  known-good {name:<30} FAILED: unexpected findings")
            for f in bad:
                report(f"    {f}")
        else:
            report(f"  known-good {name:<30} clean ({dt:.1f}s, ok)")
    report("shardcheck self-check: " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


def contracts(report=print, device=None) -> int:
    """Re-prove the ZeRO / accumulation / bf16 / fp32-identity / sp-ring
    step contracts on the real ``ParallelTrainer`` steps of the fixture
    net (needs a group of two ranks; the nets run on ``device``, ``None``
    meaning the card)."""
    import time
    from deeplearning4j_tpu_torch.analysis.fixtures import (
        contract_checks,
    )
    t_total = time.perf_counter()
    failures = []
    report("shardcheck contracts (dp=2, one recorded step each):")
    for label, check in contract_checks(device=device):
        t0 = time.perf_counter()
        try:
            problems = check()
        except Exception as e:  # noqa: BLE001 — a crash IS a gate failure
            problems = [f"crashed: {e!r}"]
        dt = time.perf_counter() - t0
        report(f"  {label:<56} {'PASS' if not problems else 'FAIL'}  "
               f"({dt:4.1f}s)")
        for p in problems:
            report(f"      {p}")
            failures.append(f"{label}: {p}")
    dt = time.perf_counter() - t_total
    report(f"shardcheck contracts: {'PASS' if not failures else 'FAIL'} "
           f"in {dt:.1f}s")
    return 0 if not failures else 1


def _rank_main(job: str, rank: int, world: int, init: str,
               device: str) -> int:
    """One rank of ``--self-check`` / ``--contracts``: joins the gloo
    group and runs the job; rank 0 prints."""
    from deeplearning4j_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.initialize(init, world_size=world, rank=rank, device=device,
                         backend="gloo", timeout_s=300.0)
    try:
        report = print if rank == 0 else (lambda *a: None)
        rc = (self_check if job == "self-check" else contracts)(
            report, device)
    finally:
        multihost.shutdown()
    return rc


def spawn(job: str, device=None, world: int = 2,
          timeout: float = 900.0) -> int:
    """Run ``job`` ("self-check" or "contracts") on ``world`` gloo ranks
    of this module: every rank on the one card (``device=None``, raising
    where there is none) or on the CPU (``device="cpu"``); returns the
    worst exit code. Rank 0's report goes to stdout."""
    import os
    import subprocess
    import sys
    import tempfile
    from pathlib import Path
    from deeplearning4j_tpu_torch.device import resolve_device
    device = resolve_device(device).type
    root = Path(__file__).resolve().parents[2]
    with tempfile.TemporaryDirectory(prefix="shardcheck-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(root)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        if device == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        procs = [subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.analysis."
             "shardcheck", "--rank-job", job, str(r), str(world), init,
             device], cwd=str(root), env=env,
            stdout=None if r == 0 else subprocess.DEVNULL)
            for r in range(world)]
        rcs = []
        try:
            for p in procs:
                rcs.append(p.wait(timeout=timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return max(rcs) if len(rcs) == world else 1


def main(argv=None) -> int:
    import argparse
    from deeplearning4j_tpu_torch.analysis.findings import (
        format_findings, has_errors,
    )
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis.shardcheck",
        description="shardcheck over recorded step programs")
    ap.add_argument("program", nargs="?",
                    help="a step program's JSON (StepProgram.to_json)")
    ap.add_argument("--wus", default="off",
                    help="declared weight_update_sharding (off|zero1|zero2)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--accum", type=int, default=1,
                    help="declared gradient_accumulation")
    ap.add_argument("--param-count", type=int, default=None)
    ap.add_argument("--precision", default=None)
    ap.add_argument("--expect-donation", action="store_true")
    ap.add_argument("--self-check", action="store_true",
                    help="fixture gate: every SC rule fires on its "
                         "known-bad step, silent on every known-good one")
    ap.add_argument("--contracts", action="store_true",
                    help="re-prove the zero1/zero2/accumulation/bf16/"
                         "fp32/sp step contracts on the real trainer")
    ap.add_argument("--device", default=None,
                    help="where --self-check / --contracts ranks run: "
                         "every rank on the card (the default; an error "
                         "without one), or cpu")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--rank-job", nargs=5, default=None,
                    metavar=("JOB", "RANK", "WORLD", "INIT", "DEVICE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.rank_job:
        job, rank, world, init, device = args.rank_job
        return _rank_main(job, int(rank), int(world), init, device)
    if args.list_rules:
        for rule, (slug, desc) in sorted(RULES.items()):
            print(f"{rule}  {slug:<26} {RULE_SEVERITY[rule]:<8} {desc}")
        return 0
    if args.self_check or args.contracts:
        from deeplearning4j_tpu_torch.device import resolve_device
        try:
            device = resolve_device(args.device).type
        except RuntimeError as e:
            ap.error(str(e))
        return spawn("self-check" if args.self_check else "contracts",
                     device)
    if not args.program:
        ap.error("a program JSON (or --self-check / --contracts) is "
                 "required")
    with open(args.program, "r", encoding="utf-8") as fh:
        try:
            program = StepProgram.from_json(fh.read())
        except ValueError as e:
            print(f"{args.program}: {e}")
            return 2
    findings = check_step_program(
        program, weight_update_sharding=args.wus, dp=args.dp, sp=args.sp,
        gradient_accumulation=args.accum, param_count=args.param_count,
        precision=args.precision,
        expect_donation=True if args.expect_donation else None)
    if findings:
        print(format_findings(findings, header=f"{args.program}:"))
    else:
        print(f"{args.program}: clean")
    return 1 if has_errors(findings) else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
