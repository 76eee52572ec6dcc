"""torchlint: an ``ast`` + ``tokenize`` lint of the port's own hot source
(the counterpart of the JAX package's ``analysis/jaxlint.py``).

It imports no torch and runs nothing. Where jaxlint lints what ``jax.jit``
traces, torchlint lints two kinds of context:

- **Captured code**, what a CUDA graph records once and replays: the body
  of a ``with torch.cuda.graph(...)`` block; the functions such a block
  calls by name in the same module (``f(...)``, ``self.m(...)``); the
  functions passed to ``torch.cuda.make_graphed_callables`` or
  ``torch.compile``, or decorated with them; the functions in
  :data:`SEAMS`, which captures reach through an attribute (each entry
  names the reference's ``jax.jit`` site it mirrors, the counterpart of
  jaxlint's "passed by name to ``jax.jit``"); and every function nested in
  one of these. A seam whose function is gone from its file is a TL008
  finding, so the table cannot rot.
- **``torch.autograd.Function`` subclasses**: the gradients' count, the
  saved tensors, and ``once_differentiable`` over a kernel's backward.

Rules (the JAX ids where the hazard carries over):

- TL001 scalar-read (error) ``float()`` / ``int()`` / ``bool()`` of a
  tensor expression, ``.item()`` / ``.tolist()``, in captured code: a
  device-to-host sync, which raises inside a capture (JL001).
- TL002 tensor-branch (error) ``if`` / ``while`` / a ternary whose test
  calls into torch or a tensor method (``.any()``, ``.all()``, ...):
  the capture records one branch and every replay takes it (JL002).
- TL003 host-sync (error) ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``np.asarray(t)``, ``torch.cuda.synchronize()``, an event's or a
  stream's ``.synchronize()``, ``print(t)`` in captured code (JL003).
- TL004 dynamic-shape (error) ``torch.nonzero``, ``masked_select``,
  ``unique*``, ``argwhere``, one-argument ``torch.where``, boolean-mask
  indexing in captured code: the output's size needs a host read. It
  replaces JL004 (loop compute): an unrolled loop costs nothing at
  replay.
- TL005 host-value-baked-in (error) ``np.random.*``, ``random.*``,
  ``datetime.now()``, and ``torch.tensor`` / ``as_tensor`` /
  ``from_numpy`` of host data (not a literal) in captured code: the
  value is fixed at capture time (JL005).
- TL006 replaced-static-input (error) in a class that captures, ``self.<a>
  = ...`` outside ``__init__`` and the capturing method, for an
  attribute the captured code reads: replay keeps reading the old
  storage; write it with ``.copy_()`` (replaces JL006, missing-donate).
- TL007 host-timer-in-capture (error) ``time.*`` timers, or a
  ``span`` / ``phase`` / ``maybe_phase`` context, in captured code: they
  time the capture, not the replay (JL007).
- TL008 stale-suppression (warning) a ``# torchlint: disable=`` comment
  that silences nothing on its line, or a seam that names no function
  (JL008).
- TL009 gradient-count (error) an ``autograd.Function.backward`` that
  returns a tuple whose length differs from ``forward``'s inputs after
  ``ctx``.
- TL010 saved-tensor-mismatch (error) ``ctx.saved_tensors`` read in
  ``backward`` with no ``ctx.save_for_backward`` in ``forward``, or
  tensors saved and never read.
- TL011 kernel-backward-not-once-differentiable (error) a ``backward``
  that reaches a launching wrapper of its module (one that calls
  ``note_launch(..., "kernel", ...)`` or ``_launch``) without
  ``@once_differentiable``: a double backward would differentiate
  through a kernel autograd cannot see.

Meta rule TL000 (warning): a suppression without a reason. Suppress a
finding on its line with ``# torchlint: disable=TL003 -- <reason>``;
the reason is mandatory (the grammar, the stale pass and the order of
the findings are ``analysis/source_lint``'s, shared with lockcheck).

The command line:

    python -m deeplearning4j_tpu_torch.analysis.torchlint [paths]
    python -m deeplearning4j_tpu_torch.analysis.torchlint --list-rules
    python -m deeplearning4j_tpu_torch.analysis.torchlint --self-check

It exits 0 when no finding survives its suppression, 1 otherwise (the
default sweep is the port's package); ``--self-check`` lints each rule's
bad / good pair of ``analysis/fixtures.TL_FIXTURES``: the bad snippet
must fire exactly its rule and the good twin nothing.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from deeplearning4j_tpu_torch.analysis.findings import Finding, Severity
from deeplearning4j_tpu_torch.analysis.source_lint import (
    LintContext, collect_suppressions, dotted as _dotted, iter_py_files,
    make_suppress_re, sort_findings, stale_suppression_pass,
)

RULES: Dict[str, Tuple[str, str]] = {
    "TL000": ("reasonless-suppression",
              "suppression comment without a '-- reason'"),
    "TL001": ("scalar-read",
              "float()/int()/bool()/.item()/.tolist() of a tensor in "
              "captured code"),
    "TL002": ("tensor-branch",
              "Python control flow on a tensor in captured code; use "
              "torch.where"),
    "TL003": ("host-sync",
              "host sync (.cpu/.numpy/np.asarray/synchronize/print) in "
              "captured code"),
    "TL004": ("dynamic-shape",
              "an op whose output size needs a host read (nonzero/"
              "masked_select/unique/boolean mask) in captured code"),
    "TL005": ("host-value-baked-in",
              "np.random/random/datetime/torch.tensor of host data in "
              "captured code is fixed at capture time"),
    "TL006": ("replaced-static-input",
              "a captured attribute rebound outside __init__ and the "
              "capture: replay reads the old storage"),
    "TL007": ("host-timer-in-capture",
              "host timer or profiling span/phase in captured code times "
              "the capture, not the replay"),
    "TL008": ("stale-suppression",
              "suppression comment that suppresses nothing on its line, "
              "or a seam that names no function"),
    "TL009": ("gradient-count",
              "autograd.Function.backward returns a number of gradients "
              "other than forward's inputs"),
    "TL010": ("saved-tensor-mismatch",
              "ctx.saved_tensors read with nothing saved, or tensors saved "
              "and never read"),
    "TL011": ("kernel-backward-not-once-differentiable",
              "a backward that launches a kernel without "
              "@once_differentiable"),
}

RULE_SEVERITY = {
    "TL000": Severity.WARNING,
    "TL001": Severity.ERROR,
    "TL002": Severity.ERROR,
    "TL003": Severity.ERROR,
    "TL004": Severity.ERROR,
    "TL005": Severity.ERROR,
    "TL006": Severity.ERROR,
    "TL007": Severity.ERROR,
    "TL008": Severity.WARNING,
    "TL009": Severity.ERROR,
    "TL010": Severity.ERROR,
    "TL011": Severity.ERROR,
}

#: the JAX rule each TL rule keeps or replaces (None: new to the port)
JAX_RULE = {"TL000": "JL000", "TL001": "JL001", "TL002": "JL002",
            "TL003": "JL003", "TL004": "JL004", "TL005": "JL005",
            "TL006": "JL006", "TL007": "JL007", "TL008": "JL008",
            "TL009": None, "TL010": None, "TL011": None}


@dataclass(frozen=True)
class Seam:
    """A function a capture reaches through an attribute: ``qualname`` in
    the file whose path ends with ``path``, and the reference's ``jax.jit``
    site it mirrors."""
    path: str
    qualname: str
    mirrors: str


#: the captures' seams: the predict runner captures a container's
#: ``_infer_fn()``; the decode runners capture what ``decode_fns`` and
#: ``paged_decode_fn`` return
SEAMS: Tuple[Seam, ...] = (
    Seam("nn/multilayer.py", "MultiLayerNetwork._infer_fn.infer",
         "deeplearning4j_tpu/nn/multilayer.py:230 jax.jit(infer)"),
    Seam("nn/graph.py", "ComputationGraph._infer_fn.infer",
         "deeplearning4j_tpu/nn/graph.py:270 jax.jit(infer)"),
    Seam("nn/graph.py", "ComputationGraph.decode_fns.prefill",
         "deeplearning4j_tpu/keras/generation.py:298 "
         "jax.jit(fn, donate_argnums=(2,))"),
    Seam("nn/graph.py", "ComputationGraph.decode_fns.decode",
         "deeplearning4j_tpu/keras/generation.py:310 (traced inside "
         "paged_decode)"),
    Seam("nn/graph.py", "ComputationGraph.paged_decode_fn.paged_decode",
         "deeplearning4j_tpu/keras/generation.py:310 "
         "jax.jit(fn, donate_argnums=(2,))"),
)

_SUPPRESS_RE = make_suppress_re("torchlint")

#: callables whose function argument a CUDA graph or a compiler captures
_CAPTURING_CALLS = {"torch.cuda.make_graphed_callables",
                    "cuda.make_graphed_callables", "make_graphed_callables",
                    "torch.compile"}
_GRAPH_CONTEXTS = ("torch.cuda.graph", "cuda.graph")

#: torch functions that return host metadata: never tensor evidence
_STATIC_TORCH = {
    "is_tensor", "is_floating_point", "is_complex", "finfo", "iinfo",
    "Size", "device", "dtype", "get_default_dtype", "is_grad_enabled",
    "is_inference_mode_enabled", "promote_types", "result_type",
    "can_cast", "no_grad", "enable_grad", "inference_mode",
    "is_available", "device_count", "current_device", "get_device_name",
    "is_current_stream_capturing",
}
_TORCH_ROOTS = ("torch.", "F.", "nn.functional.")

#: tensor methods that compute on the device (tensor evidence, and the
#: tests TL002 looks for)
_TENSOR_METHODS = {
    "any", "all", "sum", "mean", "max", "min", "norm", "prod", "abs",
    "isnan", "isinf", "isfinite", "eq", "ne", "gt", "lt", "ge", "le",
    "argmax", "argmin", "std", "var", "count_nonzero", "allclose",
    "equal", "amax", "amin",
}

#: calls and attributes that reduce a tensor to host metadata
_STATICIZING_FNS = {"len", "isinstance", "hasattr", "getattr", "type",
                    "range", "np.prod", "numpy.prod", "math.prod"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                 "requires_grad", "layout"}
_STATIC_METHODS = {"size", "dim", "numel", "stride", "element_size",
                   "data_ptr", "get_device", "nelement", "is_contiguous"}

_DYNAMIC_FNS = {"torch.nonzero", "torch.masked_select", "torch.unique",
                "torch.unique_consecutive", "torch.argwhere"}
_DYNAMIC_METHODS = {"nonzero", "masked_select", "unique",
                    "unique_consecutive", "argwhere"}
_MASK_FNS = {"isnan", "isinf", "isfinite", "logical_and", "logical_or",
             "logical_not", "logical_xor", "bool"}

_HOST_TENSOR_FNS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy",
                    "torch.Tensor"}

_IMPURE_RE = re.compile(
    r"^(np\.random\.\w+|numpy\.random\.\w+"
    r"|random\.(random|randint|uniform|choice|shuffle|gauss|randrange|sample)"
    r"|datetime\.(datetime\.)?(now|utcnow|today))$")

_HOST_TIMER_RE = re.compile(
    r"^time\.(time|perf_counter|perf_counter_ns|monotonic|monotonic_ns"
    r"|process_time|process_time_ns)$")

_SPAN_ATTRS = {"span", "phase"}
_SPAN_FNS = {"maybe_phase"}

_FUNCTION_BASES = {"torch.autograd.Function", "autograd.Function",
                   "Function"}

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]


# ---------------------------------------------------------------------------
# tensor evidence
# ---------------------------------------------------------------------------

def _is_torch_call(node: ast.Call) -> bool:
    name = _dotted(node.func)
    return (name is not None and name.startswith(_TORCH_ROOTS)
            and name.rsplit(".", 1)[-1] not in _STATIC_TORCH)


#: module roots whose functions share a tensor method's name (np.prod)
_HOST_MODULES = {"np", "numpy", "math", "statistics", "builtins"}


def _is_tensor_method_call(node: ast.Call) -> bool:
    if not (isinstance(node.func, ast.Attribute)
            and node.func.attr in _TENSOR_METHODS):
        return False
    name = _dotted(node.func)
    return name is None or name.split(".", 1)[0] not in _HOST_MODULES


def _device_evidence(node: ast.AST) -> bool:
    """A torch call or a tensor method call somewhere in ``node``."""
    return any(isinstance(n, ast.Call)
               and (_is_torch_call(n) or _is_tensor_method_call(n))
               for n in ast.walk(node))


def _references_any(node: ast.AST, names: Set[str]) -> bool:
    """A reference to one of ``names``, skipping what reduces a tensor to
    host metadata (``len(t)``, ``t.shape``, ``t.size(0)``)."""
    if isinstance(node, ast.Call):
        if _dotted(node.func) in _STATICIZING_FNS:
            return False
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _STATIC_METHODS):
            return False
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return False
    if isinstance(node, ast.Name):
        return node.id in names
    return any(_references_any(c, names) for c in ast.iter_child_nodes(node))


def _is_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp):
        return _is_literal(node.operand)
    if isinstance(node, (ast.List, ast.Tuple)):
        return all(_is_literal(e) for e in node.elts)
    return False


def _is_bool_mask(node: ast.AST) -> bool:
    """An index that selects by a boolean mask (its size is data)."""
    if isinstance(node, ast.Tuple):
        return any(_is_bool_mask(e) for e in node.elts)
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _is_bool_mask(node.operand)
    if isinstance(node, ast.Call):
        func = node.func
        last = func.attr if isinstance(func, ast.Attribute) else getattr(
            func, "id", "")
        return last in _MASK_FNS
    return False


def _function_params(fn: FunctionNode) -> Set[str]:
    a = fn.args
    names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
             + [v for v in (a.vararg, a.kwarg) if v is not None]}
    return names - {"self", "cls"}


# ---------------------------------------------------------------------------
# the rules over one captured context
# ---------------------------------------------------------------------------

def _nested_ids(stmts: Sequence[ast.AST], owner: Optional[ast.AST] = None
                ) -> Set[int]:
    """Ids of every node inside a function nested in ``stmts`` (linted
    as a context of its own)."""
    nested: Set[int] = set()
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not owner:
                nested.update(id(x) for x in ast.walk(node))
    return nested


def _lint_captured(stmts: Sequence[ast.AST], names: Set[str],
                   ctx: LintContext, owner: Optional[ast.AST] = None
                   ) -> None:
    """TL001-TL005 and TL007 over ``stmts`` of one captured context (not
    descending into nested functions). ``names``: the names whose values
    count as tensors (the parameters of the context's function)."""

    def tensor(expr: ast.AST) -> bool:
        return _references_any(expr, names) or _device_evidence(expr)

    nested = _nested_ids(stmts, owner)
    for stmt in stmts:
        for node in ast.walk(stmt):
            if id(node) in nested:
                continue
            if isinstance(node, ast.Call):
                _lint_call(node, tensor, ctx)
            if isinstance(node, ast.Subscript) \
                    and _is_bool_mask(node.slice):
                ctx.emit("TL004", node,
                         "boolean-mask indexing in captured code: the "
                         "result's size is data, read on the host",
                         "select with torch.where / multiply by the mask "
                         "and keep the shape static")
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    c = item.context_expr
                    if not isinstance(c, ast.Call):
                        continue
                    if ((isinstance(c.func, ast.Attribute)
                         and c.func.attr in _SPAN_ATTRS)
                            or (isinstance(c.func, ast.Name)
                                and c.func.id in _SPAN_FNS)):
                        ctx.emit("TL007", node,
                                 "profiling span/phase context in captured "
                                 "code times the CAPTURE (it runs once), "
                                 "not the replays",
                                 "open the span around the replay, on the "
                                 "host")
            if isinstance(node, (ast.If, ast.While)) \
                    and _device_evidence(node.test):
                kw = "while" if isinstance(node, ast.While) else "if"
                ctx.emit("TL002", node,
                         f"`{kw}` on a tensor expression in captured code: "
                         "the capture records one branch and every replay "
                         "takes it",
                         "compute both sides and select with torch.where")
            if isinstance(node, ast.IfExp) and _device_evidence(node.test):
                ctx.emit("TL002", node,
                         "ternary on a tensor expression in captured code: "
                         "the capture records one branch",
                         "use torch.where")


def _lint_call(node: ast.Call, tensor, ctx: LintContext) -> None:
    name = _dotted(node.func)
    attr = node.func.attr if isinstance(node.func, ast.Attribute) else None
    # TL001: scalar reads
    if (isinstance(node.func, ast.Name)
            and node.func.id in ("float", "int", "bool")
            and len(node.args) == 1 and tensor(node.args[0])):
        ctx.emit("TL001", node,
                 f"{node.func.id}() of a tensor reads it on the host; "
                 "inside a capture the sync raises",
                 "keep it a tensor (a 0-d tensor broadcasts), or read it "
                 "after the replay")
    if attr in ("item", "tolist") and not node.args \
            and not _is_literal(node.func.value):
        ctx.emit("TL001", node,
                 f".{attr}() syncs the device and reads the tensor on "
                 "the host; inside a capture it raises",
                 "return the tensor and read it after the replay")
    # TL003: host syncs
    if attr in ("cpu", "numpy") and not _is_literal(node.func.value):
        ctx.emit("TL003", node,
                 f".{attr}() copies to the host in captured code: a sync "
                 "the capture refuses",
                 "copy to the host after the replay")
    elif attr == "to" and (
            any(isinstance(a, ast.Constant) and a.value == "cpu"
                for a in node.args)
            or any(k.arg == "device" and isinstance(k.value, ast.Constant)
                   and k.value.value == "cpu" for k in node.keywords)):
        ctx.emit("TL003", node,
                 '.to("cpu") copies to the host in captured code',
                 "copy to the host after the replay")
    elif attr == "synchronize":
        ctx.emit("TL003", node,
                 f"{name or '.synchronize'}() in captured code waits on "
                 "the host; a capture refuses it",
                 "synchronize around the replay, not inside the capture")
    elif (name in ("np.asarray", "np.array", "numpy.asarray",
                   "numpy.array") and node.args and tensor(node.args[0])):
        ctx.emit("TL003", node,
                 f"{name}() of a tensor pulls it to the host",
                 "keep it a tensor; convert after the replay")
    elif (isinstance(node.func, ast.Name) and node.func.id == "print"
          and any(tensor(a) for a in node.args)):
        ctx.emit("TL003", node,
                 "print() of a tensor syncs (and prints once, at capture)",
                 "print after the replay")
    # TL004: dynamic shapes
    if name in _DYNAMIC_FNS or (attr in _DYNAMIC_METHODS
                                and name not in _DYNAMIC_FNS
                                and not (name or "").startswith("np.")):
        ctx.emit("TL004", node,
                 f"{name or '.' + attr}() in captured code: its output's "
                 "size is data, read on the host",
                 "keep the shape static (a mask, torch.where, a padded "
                 "bound)")
    elif name == "torch.where" and len(node.args) == 1:
        ctx.emit("TL004", node,
                 "one-argument torch.where is nonzero(): its size is data",
                 "use the three-argument torch.where")
    # TL005: host values baked in
    if name and _IMPURE_RE.match(name):
        ctx.emit("TL005", node,
                 f"{name}() in captured code is drawn ONCE, at capture, "
                 "and every replay reuses it",
                 "pass the value in through a static input, or draw on "
                 "the device")
    elif (name in _HOST_TENSOR_FNS and node.args
          and not _is_literal(node.args[0])):
        ctx.emit("TL005", node,
                 f"{name}() of host data in captured code copies the value "
                 "at capture; replays reuse it",
                 "copy new host data into a static input with .copy_() "
                 "before the replay")
    # TL007: host timers
    if name and _HOST_TIMER_RE.match(name):
        ctx.emit("TL007", node,
                 f"{name}() in captured code runs once, at capture: it "
                 "times the capture, not the replays",
                 "time the replay on the host (or with CUDA events) "
                 "around graph.replay()")


# ---------------------------------------------------------------------------
# finding the captured contexts
# ---------------------------------------------------------------------------

def _is_graph_context(with_node: ast.AST) -> bool:
    if not isinstance(with_node, (ast.With, ast.AsyncWith)):
        return False
    for item in with_node.items:
        c = item.context_expr
        if isinstance(c, ast.Call) and _dotted(c.func) in _GRAPH_CONTEXTS:
            return True
    return False


def _decorator_captures(dec: ast.AST) -> bool:
    name = _dotted(dec.func if isinstance(dec, ast.Call) else dec)
    return name in _CAPTURING_CALLS


class _Scopes(ast.NodeVisitor):
    """One pass over a module: each function's qualname, enclosing class
    and enclosing function, the module's functions by name, its capture
    blocks and its calls of a capturing callable (with their class)."""

    def __init__(self):
        self.qualname: Dict[int, str] = {}
        self.by_qualname: Dict[str, ast.AST] = {}
        self.cls_of: Dict[int, Optional[ast.ClassDef]] = {}
        self.fn_of: Dict[int, Optional[ast.AST]] = {}
        self.module_fns: Dict[str, ast.AST] = {}
        self.blocks: List[Tuple[ast.AST, Optional[ast.ClassDef],
                                Optional[ast.AST]]] = []
        self.capturing: List[Tuple[ast.Call, Optional[ast.ClassDef]]] = []
        self._stack: List[str] = []
        self._cls: List[Optional[ast.ClassDef]] = [None]
        self._fn: List[Optional[ast.AST]] = [None]

    def visit_ClassDef(self, node):
        self._stack.append(node.name)
        self._cls.append(node)
        self._fn.append(None)
        self.generic_visit(node)
        self._fn.pop()
        self._cls.pop()
        self._stack.pop()

    def _function(self, node):
        self._stack.append(node.name)
        q = ".".join(self._stack)
        self.qualname[id(node)] = q
        self.by_qualname.setdefault(q, node)
        self.cls_of[id(node)] = self._cls[-1]
        self.fn_of[id(node)] = self._fn[-1]
        if len(self._stack) == 1:
            self.module_fns[node.name] = node
        self._fn.append(node)
        self._cls.append(self._cls[-1])
        self.generic_visit(node)
        self._cls.pop()
        self._fn.pop()
        self._stack.pop()

    visit_FunctionDef = _function
    visit_AsyncFunctionDef = _function

    def visit_With(self, node):
        if _is_graph_context(node):
            self.blocks.append((node, self._cls[-1], self._fn[-1]))
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    def visit_Call(self, node):
        if _dotted(node.func) in _CAPTURING_CALLS and node.args:
            self.capturing.append((node, self._cls[-1]))
        self.generic_visit(node)


def _methods(cls: Optional[ast.ClassDef]) -> Dict[str, ast.AST]:
    if cls is None:
        return {}
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _callee(func: ast.AST, scopes: _Scopes, cls: Optional[ast.ClassDef]
            ) -> Optional[ast.AST]:
    """The function of this module a call or a callable names: ``f`` (a
    module function) or ``self.m`` (a method of the enclosing class)."""
    if isinstance(func, ast.Name):
        return scopes.module_fns.get(func.id)
    if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
            and func.value.id == "self"):
        return _methods(cls).get(func.attr)
    return None


def seams_for(path: str) -> List[Seam]:
    """The seams whose file ``path`` is."""
    p = str(path).replace("\\", "/")
    return [s for s in SEAMS if p.endswith("/" + s.path) or p == s.path]


def _captured_roots(tree: ast.Module, scopes: _Scopes,
                    seams: Sequence[Seam], ctx: LintContext
                    ) -> Tuple[Set[int], Set[int]]:
    """Ids of the functions (and lambdas) captured as roots: the ones a
    capture block calls, the ones handed to a capturing callable or
    decorated with one, and the seams (a seam that names nothing is a
    TL008 finding, at line 0 of its file)."""
    roots: Set[int] = set()
    lambdas: Set[int] = set()
    for block, cls, _ in scopes.blocks:
        for stmt in block.body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call):
                    f = _callee(n.func, scopes, cls)
                    if f is not None:
                        roots.add(id(f))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and any(_decorator_captures(d) for d in node.decorator_list):
            roots.add(id(node))
    for call, cls in scopes.capturing:
        first = call.args[0]
        for a in (first.elts if isinstance(first, (ast.Tuple, ast.List))
                  else [first]):
            if isinstance(a, ast.Lambda):
                lambdas.add(id(a))
                continue
            f = _callee(a, scopes, cls)
            if f is not None:
                roots.add(id(f))
    for seam in seams:
        f = scopes.by_qualname.get(seam.qualname)
        if f is None:
            ctx.emit("TL008", ast.Module(body=[], type_ignores=[]),
                     f"seam {seam.qualname} (mirroring {seam.mirrors}) "
                     "names no function in this file",
                     "point the entry of torchlint.SEAMS at the function "
                     "the capture reaches now, or drop it")
        else:
            roots.add(id(f))
    return roots, lambdas


def _self_attrs(stmts: Sequence[ast.AST], ctx_type) -> List[ast.Attribute]:
    return [n for stmt in stmts for n in ast.walk(stmt)
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ctx_type)
            and isinstance(n.value, ast.Name) and n.value.id == "self"]


def _lint_static_inputs(scopes: _Scopes, captured: Set[int],
                        ctx: LintContext) -> None:
    """TL006 over each class that captures a graph."""
    by_cls: Dict[int, Tuple[ast.ClassDef, Set[str]]] = {}
    for block, cls, fn in scopes.blocks:
        if cls is None:
            continue
        cap = by_cls.setdefault(id(cls), (cls, set()))[1]
        if fn is not None:
            cap.add(fn.name)
    for cls, capturing in by_cls.values():
        methods = _methods(cls)
        read: Set[str] = set()
        for block, bcls, _ in scopes.blocks:
            if bcls is cls:
                read |= {a.attr for a in _self_attrs(block.body, ast.Load)}
        for name, m in methods.items():
            if id(m) in captured:
                read |= {a.attr for a in _self_attrs(m.body, ast.Load)}
        exempt = {"__init__"} | capturing | {
            name for name, m in methods.items() if id(m) in captured}
        for name, m in methods.items():
            if name in exempt:
                continue
            for a in _self_attrs(m.body, ast.Store):
                if a.attr in read:
                    ctx.emit("TL006", a,
                             f"self.{a.attr} is rebound in {name}() but the "
                             f"graph {cls.name} captures reads it: replays "
                             "keep reading the old tensor's storage",
                             f"write into it in place "
                             f"(self.{a.attr}.copy_(...)), or capture again")


# ---------------------------------------------------------------------------
# autograd.Function
# ---------------------------------------------------------------------------

def _launching(tree: ast.Module, scopes: _Scopes) -> Set[str]:
    """The module functions that launch a kernel: they call
    ``note_launch(..., "kernel", ...)`` or ``_launch``, or a function that
    does."""
    def direct(fn) -> bool:
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            name = _dotted(n.func) or ""
            if name.rsplit(".", 1)[-1] == "_launch":
                return True
            if (name.rsplit(".", 1)[-1] == "note_launch"
                    and len(n.args) > 1
                    and isinstance(n.args[1], ast.Constant)
                    and n.args[1].value == "kernel"):
                return True
        return False
    calls = {name: {n.func.id for n in ast.walk(fn)
                    if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Name)}
             for name, fn in scopes.module_fns.items()}
    out = {name for name, fn in scopes.module_fns.items() if direct(fn)}
    grew = True
    while grew:
        grew = False
        for name, called in calls.items():
            if name not in out and called & out:
                out.add(name)
                grew = True
    return out


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    return any(_dotted(b) in _FUNCTION_BASES for b in cls.bases)


def _lint_autograd_function(cls: ast.ClassDef, launching: Set[str],
                            ctx: LintContext) -> None:
    methods = _methods(cls)
    fwd, bwd = methods.get("forward"), methods.get("backward")
    setup = methods.get("setup_context")
    if fwd is None or bwd is None:
        return
    # TL009: the gradients' count
    a = fwd.args
    if a.vararg is None:
        n_inputs = len(a.posonlyargs + a.args)
        if setup is None:
            n_inputs -= 1                      # ctx
        for ret in (n for n in ast.walk(bwd) if isinstance(n, ast.Return)):
            v = ret.value
            if isinstance(v, ast.Tuple) and not any(
                    isinstance(e, ast.Starred) for e in v.elts):
                got = len(v.elts)
            elif v is None or isinstance(v, ast.Constant):
                got = 1
            else:
                continue
            if got != n_inputs:
                ctx.emit("TL009", ret,
                         f"{cls.name}.backward returns {got} gradient(s) "
                         f"for forward's {n_inputs} input(s)",
                         "return one gradient (or None) per forward input "
                         "after ctx")
    # TL010: saved tensors
    saves = [n for m in (fwd, setup) if m is not None
             for n in ast.walk(m) if isinstance(n, ast.Call)
             and (_dotted(n.func) or "").endswith(".save_for_backward")]
    reads = [n for n in ast.walk(bwd) if isinstance(n, ast.Attribute)
             and n.attr in ("saved_tensors", "saved_variables")]
    if reads and not saves:
        ctx.emit("TL010", reads[0],
                 f"{cls.name}.backward reads ctx.saved_tensors but forward "
                 "saves nothing: the backward unpacks an empty tuple",
                 "ctx.save_for_backward(...) the tensors in forward")
    elif saves and not reads:
        ctx.emit("TL010", saves[0],
                 f"{cls.name}.forward saves tensors its backward never "
                 "reads: they stay alive until the graph is freed",
                 "save only what backward reads")
    # TL011: a kernel's backward without once_differentiable
    once = any((_dotted(d) or "").endswith("once_differentiable")
               for d in bwd.decorator_list)
    if not once:
        reaches = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id in launching for n in ast.walk(bwd))
        if reaches:
            ctx.emit("TL011", bwd,
                     f"{cls.name}.backward launches a kernel autograd "
                     "cannot differentiate, without @once_differentiable: "
                     "a double backward would silently treat it as a "
                     "constant",
                     "decorate backward with "
                     "@torch.autograd.function.once_differentiable")


# ---------------------------------------------------------------------------
# per-file lint
# ---------------------------------------------------------------------------

def _lint_module(tree: ast.Module, ctx: LintContext,
                 seams: Sequence[Seam]) -> None:
    scopes = _Scopes()
    scopes.visit(tree)
    roots, root_lambdas = _captured_roots(tree, scopes, seams, ctx)
    captured: Set[int] = set()

    def visit(node: ast.AST, in_captured: bool) -> None:
        here = in_captured
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            here = in_captured or id(node) in roots
            if here:
                captured.add(id(node))
                _lint_captured(node.body, _function_params(node), ctx, node)
        elif isinstance(node, ast.Lambda):
            here = in_captured or id(node) in root_lambdas
            if here:
                captured.add(id(node))
                _lint_captured([node.body], _function_params(node), ctx,
                               node)
        elif _is_graph_context(node) and not in_captured:
            fn = next((f for b, _, f in scopes.blocks if b is node), None)
            names = _function_params(fn) if fn is not None else set()
            _lint_captured(node.body, names, ctx)
            for stmt in node.body:
                visit(stmt, True)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, here)

    visit(tree, False)
    _lint_static_inputs(scopes, captured, ctx)
    launching = _launching(tree, scopes)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and _is_autograd_function(node):
            _lint_autograd_function(node, launching, ctx)


def lint_source(source: str, path: str = "<string>",
                seams: Optional[Sequence[Seam]] = None) -> List[Finding]:
    """Lint one file's source text. ``seams``: the seams in this file
    (default: the entries of :data:`SEAMS` whose file ``path`` is)."""
    findings: List[Finding] = []
    suppressed = collect_suppressions(source, findings, path, _SUPPRESS_RE,
                                      "TL000", RULE_SEVERITY["TL000"])
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        findings.append(Finding(
            "TL000", Severity.ERROR, f"{path}:{e.lineno or 0}",
            f"syntax error: {e.msg}", ""))
        return findings
    ctx = LintContext(path=path, suppressed=suppressed,
                      severity=RULE_SEVERITY, findings=findings)
    _lint_module(tree, ctx, seams_for(path) if seams is None else seams)
    stale_suppression_pass(ctx, "TL008")
    sort_findings(ctx.findings)
    return ctx.findings


def lint_paths(paths: List[str]) -> List[Finding]:
    """Lint the .py files under the given files / directories."""
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_source(f.read_text(encoding="utf-8"), str(f)))
    return findings


def package_dir() -> str:
    """The port's package directory: the default sweep."""
    return str(Path(__file__).resolve().parent.parent)


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def self_check(report=print) -> int:
    """Every rule's bad fixture fires exactly its rule and every good twin
    nothing; 0 when all hold, 1 otherwise."""
    from deeplearning4j_tpu_torch.analysis.fixtures import TL_FIXTURES
    failures = []
    for rule, (bad, good) in sorted(TL_FIXTURES.items()):
        got = [f.rule for f in lint_source(bad, f"<{rule}-bad>")]
        if got != [rule]:
            failures.append(f"{rule}: bad fixture fired {got or 'nothing'}, "
                            f"expected [{rule}]")
        got = [f.rule for f in lint_source(good, f"<{rule}-good>")]
        if got:
            failures.append(f"{rule}: good fixture fired {got}")
    missing = set(RULES) - set(TL_FIXTURES) - {"TL000"}
    if missing:
        failures.append(f"rules without fixtures: {sorted(missing)}")
    if failures:
        report("torchlint --self-check FAILED:")
        for f in failures:
            report("  " + f)
        return 1
    report(f"torchlint --self-check: {len(TL_FIXTURES)} rule fixtures OK")
    return 0


def main(argv=None) -> int:
    import argparse
    from deeplearning4j_tpu_torch.analysis.findings import format_findings
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis.torchlint",
        description="Lint captured code and autograd Functions.")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files / directories to lint (default: the "
                         "port's package)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--self-check", action="store_true",
                    help="lint the per-rule fixtures and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, (slug, desc) in sorted(RULES.items()):
            was = JAX_RULE[rule] or "-"
            print(f"{rule}  {slug:<40} {RULE_SEVERITY[rule]:<8} "
                  f"{was:<6} {desc}")
        return 0
    if args.self_check:
        return self_check()
    findings = lint_paths(args.paths or [package_dir()])
    if findings:
        print(format_findings(findings, header="torchlint findings:"))
        return 1
    print("torchlint: clean")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
