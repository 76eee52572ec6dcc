"""lockcheck: AST-based concurrency analyzer for the threaded host stack
(the JAX package's ``analysis/lockcheck.py``, kept as the port's own
copy: the same rules, messages and findings on the same source).

One of the port's static-analysis layers (graphcheck, torchlint,
lockcheck, shardcheck). The others prove the *device* program right;
this one proves the *host* program around it — batching dispatchers, the
token-level decode loop, the broker, reader/decoder pools, heartbeats —
free of the deadlock and race classes that stall a serving fleet
silently (a reader/decoder pool that posts its poison pill under a lock
is one); lockcheck makes that class of bug a check failure instead of a
hunt on a live system.

Pure ``ast`` + ``tokenize`` — no imports of the analyzed code, no
execution; runs in milliseconds over the tree.

Rules (stable ids):

- LC001 lock-order-cycle   (error)   the per-module lock-acquisition
        graph (nested ``with <lock>:`` / ``.acquire()`` scopes, plus
        acquisitions reached through same-module call edges) contains a
        cycle — two threads taking the locks in opposite orders
        deadlock. Re-acquiring a non-reentrant lock already held (a
        1-cycle) is the same rule.
- LC002 blocking-under-lock (error)  a blocking call — socket
        send/recv/accept/connect, ``time.sleep``, ``subprocess``,
        ``Future.result()``, unbounded ``queue.get()``/``put()``,
        ``.lower(...).compile()``, ``block_until_ready``, an unbounded
        ``wait()`` — executes while a lock is held, directly or through
        a same-module call chain. Every thread that wants the lock
        stalls behind the slow operation (the poison-posting deadlock class).
- LC003 wait-not-in-while  (error)   ``Condition.wait()`` not wrapped
        in a predicate ``while`` loop — spurious wakeups and stolen
        wakeups make a bare ``if``+``wait`` see stale state.
- LC004 unlocked-write     (warning) an attribute written both under a
        lock and without one elsewhere in the same class — either the
        lock is unnecessary or the unlocked write is a race.
- LC005 leaked-thread      (error)   a ``threading.Thread`` stored on
        an object is never ``join()``ed on the class's
        ``stop()``/``drain()``/``close()``/``shutdown()`` path (or no
        such path exists). Daemon threads are not exempt: a daemon that
        outlives ``drain()`` still races teardown — deliberately
        abandonable threads need an explicit suppression with a reason.
- LC006 notify-outside-lock (error)  ``notify()``/``notify_all()`` on a
        Condition that is not held at the call site — RuntimeError at
        runtime, or a lost wakeup if the condition is re-derived.
- LC008 timer-not-cancelled (error)  a ``threading.Timer`` stored on an
        object is never ``cancel()``ed (or ``join()``ed) on the class's
        teardown path — the armed timer fires after the object is
        logically dead (LC005's one-shot sibling; Timer subclasses
        Thread but the idiomatic teardown verb is ``cancel``).

Meta rules: LC000 (warning) reasonless suppression; LC007 (warning)
stale suppression — a ``# lockcheck: disable=<rule>`` comment that
silenced nothing on its line (same semantics as torchlint's TL008; the
machinery is shared via ``analysis/source_lint.py``).

Lock identity is lexical, per module: ``self.<attr>`` assigned a
``threading.Lock/RLock/Condition`` anywhere in a class, module-level
lock globals, locals bound to a lock constructor, plus a naming
heuristic (``*lock*``/``*cond*``/``*cv*``/``*sem*``) for locks that
arrive through parameters or foreign objects (``gen.ready_cv``).
Analysis is inter-procedural WITHIN a module: acquisitions and blocking
calls propagate through ``self.method()`` and module-function call
edges. Cross-module flows are out of scope by design — module
boundaries are where the repo documents its lock leaves (e.g. "the
CompileCache lock is a leaf — no path nests it around the cond").

Suppression: ``# lockcheck: disable=LC005 -- <reason>`` on the
offending line; reasons are mandatory (LC000) and must stay live
(LC007).

The command line (the JAX package's ``tools/lockcheck.py``):

    python -m deeplearning4j_tpu_torch.analysis.lockcheck [paths]
    python -m deeplearning4j_tpu_torch.analysis.lockcheck --list-rules
    python -m deeplearning4j_tpu_torch.analysis.lockcheck --self-check

It exits 0 when no finding survives its suppression, 1 otherwise (the
default sweep is the port's package); ``--self-check`` analyzes each
rule's bad / good pair of ``analysis/fixtures.LC_FIXTURES``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Set, Tuple

from deeplearning4j_tpu_torch.analysis.findings import Finding, Severity
from deeplearning4j_tpu_torch.analysis.source_lint import (
    LintContext, collect_suppressions, dotted, iter_py_files,
    make_suppress_re, sort_findings, stale_suppression_pass,
)

RULES: Dict[str, Tuple[str, str]] = {
    "LC000": ("reasonless-suppression",
              "suppression comment without a '-- reason'"),
    "LC001": ("lock-order-cycle",
              "lock-acquisition graph has a cycle (or a non-reentrant "
              "lock is re-acquired while held) — deadlock"),
    "LC002": ("blocking-under-lock",
              "blocking call (socket/sleep/subprocess/Future.result/"
              "compile/unbounded wait) while holding a lock"),
    "LC003": ("wait-not-in-while",
              "Condition.wait() not wrapped in a predicate while loop "
              "(spurious/stolen wakeups see stale state)"),
    "LC004": ("unlocked-write",
              "attribute written both under a lock and without one "
              "elsewhere in the same class"),
    "LC005": ("leaked-thread",
              "Thread stored on an object but never joined on its "
              "stop()/drain()/close() path"),
    "LC006": ("notify-outside-lock",
              "notify()/notify_all() without holding the owning lock"),
    "LC007": ("stale-suppression",
              "suppression comment that suppresses nothing on its line "
              "(rots silently and would swallow future findings)"),
    "LC008": ("timer-not-cancelled",
              "threading.Timer stored on an object but never cancelled "
              "(or joined) on its stop()/drain()/close() path"),
}

RULE_SEVERITY = {
    "LC000": Severity.WARNING,
    "LC001": Severity.ERROR,
    "LC002": Severity.ERROR,
    "LC003": Severity.ERROR,
    "LC004": Severity.WARNING,
    "LC005": Severity.ERROR,
    "LC006": Severity.ERROR,
    "LC007": Severity.WARNING,
    "LC008": Severity.ERROR,
}

_SUPPRESS_RE = make_suppress_re("lockcheck")

_LOCK_CTORS = {"threading.Lock", "Lock"}
_RLOCK_CTORS = {"threading.RLock", "RLock"}
_COND_CTORS = {"threading.Condition", "Condition"}
_THREAD_CTORS = {"threading.Thread", "Thread"}
_TIMER_CTORS = {"threading.Timer", "Timer"}

# naming heuristic for locks that arrive via parameters, tuple unpacks,
# or foreign objects (gen.ready_cv, sched._cond): the last path segment
# must LOOK like a lock. Kept tight — a false lock here would fabricate
# held-regions and LC002 noise.
_LOCKISH_RE = re.compile(
    r"(?:^|_|\.)(?:lock|mutex|mtx|sem|semaphore|cv|cond|condition)s?"
    r"(?:\[[^\]]*\])?$", re.I)
_CONDISH_RE = re.compile(
    r"(?:^|_|\.)(?:cv|cond|condition)s?(?:\[[^\]]*\])?$", re.I)

# method names that root a teardown path for LC005
_STOP_NAMES = {"stop", "drain", "close", "shutdown", "terminate",
               "stop_all", "__exit__", "__del__"}

# definitely-blocking dotted call targets
_BLOCKING_DOTTED = {
    "time.sleep", "os.system", "socket.create_connection",
    "urllib.request.urlopen", "jax.block_until_ready",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
}
# definitely-blocking attribute calls on any receiver
_BLOCKING_ATTRS = {"recv", "recv_into", "sendall", "accept", "connect",
                   "block_until_ready"}


def _expr_text(node: ast.AST) -> Optional[str]:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - malformed synthetic nodes
        return None


def _ctor_kind(value: ast.AST) -> Optional[str]:
    """'lock' / 'rlock' / 'cond' when the expression contains a
    threading lock constructor (``threading.Condition(some_lock)``
    reports 'cond': ast.walk yields the outermost call first)."""
    for n in ast.walk(value):
        if isinstance(n, ast.Call):
            d = dotted(n.func)
            if d in _COND_CTORS:
                return "cond"
            if d in _RLOCK_CTORS:
                return "rlock"
            if d in _LOCK_CTORS:
                return "lock"
    return None


def _is_thread_expr(value: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and dotted(n.func) in _THREAD_CTORS
               for n in ast.walk(value))


def _is_timer_expr(value: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and dotted(n.func) in _TIMER_CTORS
               for n in ast.walk(value))


def _self_attrs_in(node: ast.AST) -> Set[str]:
    """Attribute names read as ``self.X`` anywhere in the expression."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                and n.value.id == "self":
            out.add(n.attr)
    return out


def _blocking_desc(node: ast.Call) -> Optional[str]:
    """A short description when the call is in the blocking set, else
    None. The set is deliberately scoped to unbounded/slow operations —
    plain file I/O and bounded (timeout-carrying) waits stay out."""
    d = dotted(node.func)
    if d in _BLOCKING_DOTTED:
        return f"{d}()"
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    kwargs = {k.arg for k in node.keywords}
    if attr in _BLOCKING_ATTRS:
        return f".{attr}()"
    if attr == "result" and not node.args and "timeout" not in kwargs:
        return ".result() with no timeout"
    if attr == "join" and not isinstance(node.func.value, ast.Constant):
        # thread/queue join: zero args, timeout kwarg only, or a single
        # numeric literal. `sep.join(parts)` string joins carry a
        # non-numeric positional argument and never match.
        if (not node.args and kwargs <= {"timeout"}) or (
                len(node.args) == 1 and not node.keywords
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, (int, float))):
            return ".join()"
    if attr == "get" and not node.args and not node.keywords:
        # dict.get always takes a key; a zero-arg .get() is a queue
        return ".get() with no timeout (unbounded queue get)"
    if attr == "put" and "timeout" not in kwargs and "block" not in kwargs:
        base = _expr_text(node.func.value) or ""
        if re.search(r"(?:^|_|\.)(?:q|queue)s?(?:\[[^\]]*\])?$", base, re.I):
            return f".put() on {base} with no timeout"
    if attr == "compile" and isinstance(node.func.value, ast.Call) \
            and isinstance(node.func.value.func, ast.Attribute) \
            and node.func.value.func.attr == "lower":
        return ".lower(...).compile()"
    return None


# ---------------------------------------------------------------------------
# per-module model
# ---------------------------------------------------------------------------

@dataclass
class _Lock:
    key: str            # graph identity, e.g. "BatchScheduler.self._cond"
    text: str           # source text at the site, e.g. "self._cond"
    kind: str           # "lock" | "rlock" | "cond"
    registered: bool    # True when we saw the constructor assignment


@dataclass
class _ClassReg:
    name: str
    lock_attrs: Dict[str, str] = field(default_factory=dict)   # attr->kind
    thread_attrs: Dict[str, int] = field(default_factory=dict)  # attr->line
    timer_attrs: Dict[str, int] = field(default_factory=dict)   # attr->line
    method_names: Set[str] = field(default_factory=set)


@dataclass
class _Func:
    qual: str                   # "Cls.method", "func", "Cls.m.<nested>"
    cls: Optional[str]
    method: Optional[str]       # top method name when inside a class
    node: ast.AST
    # events, each with the tuple of held lock keys at the site
    acquires: List[Tuple[_Lock, int, Tuple[str, ...]]] = \
        field(default_factory=list)
    blocking: List[Tuple[str, int, List[_Lock]]] = field(default_factory=list)
    calls: List[Tuple[Tuple[str, str], int, List[_Lock]]] = \
        field(default_factory=list)
    waits: List[Tuple[_Lock, int, List[_Lock], bool, bool]] = \
        field(default_factory=list)  # (cond, line, held, in_while, bounded)
    notifies: List[Tuple[_Lock, int, List[_Lock]]] = field(default_factory=list)
    writes: List[Tuple[str, int, bool]] = field(default_factory=list)
    joins: Set[str] = field(default_factory=set)
    cancels: Set[str] = field(default_factory=set)


class _ModuleScan:
    """One module's lock/thread registry plus per-function event lists;
    the rule passes below read these."""

    def __init__(self, tree: ast.Module, ctx: LintContext):
        self.ctx = ctx
        self.tree = tree
        self.global_locks: Dict[str, str] = {}      # name -> kind
        self.classes: Dict[str, _ClassReg] = {}
        self.funcs: Dict[str, _Func] = {}
        self._register(tree)
        for cls, fn in self._iter_defs(tree):
            self._scan_function(fn, cls, self._qual(cls, fn.name))

    # ---------------------------------------------------------- registry

    def _register(self, tree: ast.Module) -> None:
        for stmt in tree.body:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                value = stmt.value
                kind = _ctor_kind(value) if value is not None else None
                if kind:
                    for t in targets:
                        if isinstance(t, ast.Name):
                            self.global_locks[t.id] = kind
            elif isinstance(stmt, ast.ClassDef):
                reg = _ClassReg(stmt.name)
                self.classes[stmt.name] = reg
                for item in stmt.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        reg.method_names.add(item.name)
                        self._register_method(item, reg)

    def _register_method(self, fn: ast.AST, reg: _ClassReg) -> None:
        # locals bound to a Thread first, so `self._d[k] = worker`
        # and `self._threads.append(t)` resolve
        local_threads: Set[str] = set()
        local_timers: Set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and _is_timer_expr(n.value):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        local_timers.add(t.id)
            elif isinstance(n, ast.Assign) and _is_thread_expr(n.value):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        local_threads.add(t.id)
        for n in ast.walk(fn):
            if isinstance(n, (ast.Assign, ast.AnnAssign)):
                targets = (n.targets if isinstance(n, ast.Assign)
                           else [n.target])
                value = n.value
                if value is None:
                    continue
                kind = _ctor_kind(value)
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        if kind:
                            reg.lock_attrs[t.attr] = kind
                        elif _is_timer_expr(value):
                            reg.timer_attrs.setdefault(t.attr, n.lineno)
                        elif _is_thread_expr(value):
                            reg.thread_attrs.setdefault(t.attr, n.lineno)
                    elif isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Attribute) \
                            and isinstance(t.value.value, ast.Name) \
                            and t.value.value.id == "self":
                        if _is_timer_expr(value) or (
                                isinstance(value, ast.Name)
                                and value.id in local_timers):
                            reg.timer_attrs.setdefault(t.value.attr,
                                                       n.lineno)
                        elif _is_thread_expr(value) or (
                                isinstance(value, ast.Name)
                                and value.id in local_threads):
                            reg.thread_attrs.setdefault(t.value.attr,
                                                        n.lineno)
            elif isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "append" \
                    and isinstance(n.func.value, ast.Attribute) \
                    and isinstance(n.func.value.value, ast.Name) \
                    and n.func.value.value.id == "self" and n.args:
                arg = n.args[0]
                if _is_timer_expr(arg) or (isinstance(arg, ast.Name)
                                           and arg.id in local_timers):
                    reg.timer_attrs.setdefault(n.func.value.attr, n.lineno)
                elif _is_thread_expr(arg) or (isinstance(arg, ast.Name)
                                              and arg.id in local_threads):
                    reg.thread_attrs.setdefault(n.func.value.attr, n.lineno)

    def _iter_defs(self, tree: ast.Module):
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield None, stmt
            elif isinstance(stmt, ast.ClassDef):
                for item in stmt.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        yield stmt.name, item

    @staticmethod
    def _qual(cls: Optional[str], name: str) -> str:
        return f"{cls}.{name}" if cls else name

    # ---------------------------------------------------- function scan

    def _scan_function(self, fn, cls: Optional[str], qual: str,
                       method: Optional[str] = None) -> None:
        if method is None:
            method = qual.split(".", 1)[1] if cls else None
        func = _Func(qual=qual, cls=cls, method=method, node=fn)
        self.funcs[qual] = func
        scan = _FunctionScan(self, func)
        scan.run()
        # nested defs run later (thread targets, workers): scan each as
        # its own function, with a fresh (empty) held set
        for nested in scan.nested:
            self._scan_function(nested, cls, f"{qual}.{nested.name}", method)


class _FunctionScan:
    def __init__(self, mod: _ModuleScan, func: _Func):
        self.mod = mod
        self.func = func
        self.local_locks: Dict[str, str] = {}        # name -> kind
        self.aliases: Dict[str, Set[str]] = {}       # local -> self attrs
        self.nested: List[ast.AST] = []
        self.while_ids: Set[int] = set()

    def run(self) -> None:
        self._collect_while_ids(self.func.node, False)
        # parameters annotated as locks join the local lock table
        args = getattr(self.func.node, "args", None)
        if args is not None:
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                ann = _expr_text(a.annotation) if a.annotation else None
                if ann and re.search(r"\b(Lock|RLock|Condition)\b",
                                     ann.strip("\"'")):
                    self.local_locks[a.arg] = (
                        "cond" if "Condition" in ann else
                        "rlock" if "RLock" in ann else "lock")
        self._block(self.func.node.body, [])

    def _collect_while_ids(self, node: ast.AST, inw: bool) -> None:
        if inw:
            self.while_ids.add(id(node))
        for ch in ast.iter_child_nodes(node):
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)) and ch is not node:
                continue
            self._collect_while_ids(ch, inw or isinstance(node, ast.While))

    # ------------------------------------------------- lock resolution

    def _resolve(self, expr: ast.AST) -> Optional[_Lock]:
        text = _expr_text(expr)
        if not text:
            return None
        scope = self.func.cls or self.func.qual
        if text.startswith("self.") and self.func.cls:
            attr = text[5:]
            reg = self.mod.classes.get(self.func.cls)
            if reg and attr in reg.lock_attrs:
                return _Lock(f"{self.func.cls}.{text}", text,
                             reg.lock_attrs[attr], True)
            if _LOCKISH_RE.search(text):
                kind = "cond" if _CONDISH_RE.search(text) else "lock"
                return _Lock(f"{self.func.cls}.{text}", text, kind, False)
            return None
        if isinstance(expr, ast.Name):
            name = expr.id
            if name in self.local_locks:
                return _Lock(f"{self.func.qual}.{name}@local", name,
                             self.local_locks[name], True)
            if name in self.mod.global_locks:
                return _Lock(f"<module>.{name}", name,
                             self.mod.global_locks[name], True)
            if _LOCKISH_RE.search(name):
                kind = "cond" if _CONDISH_RE.search(name) else "lock"
                return _Lock(f"{self.func.qual}.{name}@local", name,
                             kind, False)
            return None
        if _LOCKISH_RE.search(text):
            kind = "cond" if _CONDISH_RE.search(text) else "lock"
            return _Lock(f"{scope}.{text}", text, kind, False)
        return None

    # ------------------------------------------------------ statements

    def _block(self, stmts: Sequence[ast.stmt], held: List[_Lock]) -> None:
        held = list(held)
        for stmt in stmts:
            self._stmt(stmt, held)

    def _stmt(self, stmt: ast.stmt, held: List[_Lock]) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            entered: List[_Lock] = []
            for item in stmt.items:
                lk = self._resolve(item.context_expr)
                if lk is not None:
                    self._acquire(lk, stmt.lineno, held)
                    held.append(lk)
                    entered.append(lk)
                else:
                    self._expr(item.context_expr, held)
            self._block(stmt.body, held)
            for lk in entered:
                held.remove(lk)
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call) \
                and isinstance(stmt.value.func, ast.Attribute) \
                and stmt.value.func.attr in ("acquire", "release") \
                and self._resolve(stmt.value.func.value) is not None:
            lk = self._resolve(stmt.value.func.value)
            if stmt.value.func.attr == "acquire":
                self._acquire(lk, stmt.lineno, held)
                held.append(lk)
            else:
                for i, h in enumerate(held):
                    if h.key == lk.key:
                        del held[i]
                        break
        elif isinstance(stmt, (ast.If,)):
            self._expr(stmt.test, held)
            self._block(stmt.body, held)
            self._block(stmt.orelse, held)
        elif isinstance(stmt, ast.While):
            self._expr(stmt.test, held)
            self._block(stmt.body, held)
            self._block(stmt.orelse, held)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, held)
            if isinstance(stmt.target, ast.Name):
                attrs = _self_attrs_in(stmt.iter)
                for n in ast.walk(stmt.iter):
                    if isinstance(n, ast.Name) and n.id in self.aliases:
                        attrs |= self.aliases[n.id]
                if attrs:
                    self.aliases[stmt.target.id] = attrs
            self._block(stmt.body, held)
            self._block(stmt.orelse, held)
        elif isinstance(stmt, ast.Try):
            self._block(stmt.body, held)
            for h in stmt.handlers:
                self._block(h.body, held)
            self._block(stmt.orelse, held)
            self._block(stmt.finalbody, held)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.nested.append(stmt)
        elif isinstance(stmt, ast.ClassDef):
            pass  # classes defined inside functions are out of scope
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            self._assign(stmt, held)
        else:
            self._expr(stmt, held)

    def _assign(self, stmt: ast.stmt, held: List[_Lock]) -> None:
        value = stmt.value
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        if value is not None:
            self._expr(value, held)
            kind = _ctor_kind(value)
            for t in targets:
                if isinstance(t, ast.Name):
                    if kind:
                        self.local_locks[t.id] = kind
                    else:
                        attrs = _self_attrs_in(value)
                        for n in ast.walk(value):
                            if isinstance(n, ast.Name) \
                                    and n.id in self.aliases:
                                attrs |= self.aliases[n.id]
                        if attrs:
                            self.aliases[t.id] = attrs
        reg = self.mod.classes.get(self.func.cls) if self.func.cls else None
        for t in targets:
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                # lock/thread/timer attributes have their own rules;
                # LC004 watches the data attributes
                if reg and (t.attr in reg.lock_attrs
                            or t.attr in reg.thread_attrs
                            or t.attr in reg.timer_attrs):
                    continue
                self.func.writes.append((t.attr, stmt.lineno, bool(held)))
            elif isinstance(t, (ast.Tuple, ast.List)):
                for el in t.elts:
                    if isinstance(el, ast.Attribute) \
                            and isinstance(el.value, ast.Name) \
                            and el.value.id == "self":
                        self.func.writes.append(
                            (el.attr, stmt.lineno, bool(held)))

    # ----------------------------------------------------- expressions

    def _expr(self, node: ast.AST, held: List[_Lock]) -> None:
        for n in ast.walk(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not isinstance(n, ast.Call):
                continue
            self._call(n, held)

    def _call(self, node: ast.Call, held: List[_Lock]) -> None:
        func = self.func
        line = node.lineno
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            target = node.func.value
            if attr in ("wait", "wait_for"):
                lk = self._resolve(target)
                bounded = bool(
                    (node.args and attr == "wait")
                    or (attr == "wait_for" and len(node.args) > 1)
                    or any(k.arg == "timeout" for k in node.keywords))
                if lk is not None and lk.kind == "cond":
                    func.waits.append((lk, line, list(held),
                                       id(node) in self.while_ids
                                       or attr == "wait_for", bounded))
                elif not bounded:
                    # Event.wait()/unknown .wait() with no timeout: an
                    # unbounded block — LC002 territory when locks are
                    # held (conditions release their own lock; events
                    # release nothing)
                    func.blocking.append((f".{attr}() with no timeout",
                                          line, list(held)))
                return
            if attr in ("notify", "notify_all"):
                lk = self._resolve(target)
                if lk is not None and lk.kind == "cond":
                    func.notifies.append((lk, line, list(held)))
                return
            if attr == "join":
                if isinstance(target, ast.Attribute) \
                        and isinstance(target.value, ast.Name) \
                        and target.value.id == "self":
                    func.joins.add(target.attr)
                elif isinstance(target, ast.Name) \
                        and target.id in self.aliases:
                    func.joins |= self.aliases[target.id]
            if attr == "cancel":
                if isinstance(target, ast.Attribute) \
                        and isinstance(target.value, ast.Name) \
                        and target.value.id == "self":
                    func.cancels.add(target.attr)
                elif isinstance(target, ast.Name) \
                        and target.id in self.aliases:
                    func.cancels |= self.aliases[target.id]
            if isinstance(target, ast.Name) and target.id == "self":
                func.calls.append((("self", attr), line, list(held)))
        elif isinstance(node.func, ast.Name):
            func.calls.append((("mod", node.func.id), line, list(held)))
        desc = _blocking_desc(node)
        if desc:
            func.blocking.append((desc, line, list(held)))

    def _acquire(self, lk: _Lock, line: int, held: List[_Lock]) -> None:
        self.func.acquires.append((lk, line, tuple(h.key for h in held)))


# ---------------------------------------------------------------------------
# rule passes
# ---------------------------------------------------------------------------

def _at(line: int) -> SimpleNamespace:
    return SimpleNamespace(lineno=line)


class _Analysis:
    def __init__(self, mod: _ModuleScan, ctx: LintContext):
        self.mod = mod
        self.ctx = ctx
        self.funcs = mod.funcs
        self._eff_acquires_memo: Dict[str, Dict[str, _Lock]] = {}
        self._eff_blocking_memo: Dict[str, List[Tuple[str, str]]] = {}

    # -------------------------------------------------- call resolution

    def _resolve_call(self, caller: _Func,
                      spec: Tuple[str, str]) -> Optional[str]:
        kind, name = spec
        if kind == "self":
            if caller.cls and f"{caller.cls}.{name}" in self.funcs:
                return f"{caller.cls}.{name}"
            return None
        nested = f"{caller.qual}.{name}"
        if nested in self.funcs:
            return nested
        return name if name in self.funcs else None

    def _eff_acquires(self, qual: str,
                      stack: Tuple[str, ...] = ()) -> Dict[str, _Lock]:
        if qual in self._eff_acquires_memo:
            return self._eff_acquires_memo[qual]
        if qual in stack:
            return {}
        func = self.funcs[qual]
        out: Dict[str, _Lock] = {}
        for lk, _line, _held in func.acquires:
            out.setdefault(lk.key, lk)
        for spec, _line, _held in func.calls:
            callee = self._resolve_call(func, spec)
            if callee:
                out.update(self._eff_acquires(callee, stack + (qual,)))
        self._eff_acquires_memo[qual] = out
        return out

    def _eff_blocking(self, qual: str,
                      stack: Tuple[str, ...] = ()) -> List[Tuple[str, str]]:
        """[(desc, via)] for blocking calls reachable from qual; `via`
        names the call chain for the finding message."""
        if qual in self._eff_blocking_memo:
            return self._eff_blocking_memo[qual]
        if qual in stack:
            return []
        func = self.funcs[qual]
        out: List[Tuple[str, str]] = [
            (desc, qual) for desc, _line, _held in func.blocking]
        for spec, _line, _held in func.calls:
            callee = self._resolve_call(func, spec)
            if callee:
                out.extend(self._eff_blocking(callee, stack + (qual,)))
        self._eff_blocking_memo[qual] = out
        return out

    # -------------------------------------------------------- the rules

    def run(self) -> None:
        self._lc001()
        self._lc002()
        self._lc003()
        self._lc004()
        self._lc005()
        self._lc006()
        self._lc008()

    def _held_names(self, held: List[_Lock]) -> str:
        return ", ".join(h.text for h in held)

    def _lc001(self) -> None:
        # edges: held -> acquired, from lexical nesting plus call edges
        edges: Dict[str, Dict[str, Tuple[str, int]]] = {}
        texts: Dict[str, str] = {}

        def add_edge(a: str, b: str, qual: str, line: int) -> None:
            edges.setdefault(a, {}).setdefault(b, (qual, line))

        for func in self.funcs.values():
            for lk, line, held_keys in func.acquires:
                texts[lk.key] = lk.text
                for h in held_keys:
                    if h == lk.key:
                        if lk.registered and lk.kind != "rlock":
                            self.ctx.emit(
                                "LC001", _at(line),
                                f"{lk.text} is re-acquired while already "
                                "held — a non-reentrant lock deadlocks "
                                "against itself",
                                "use threading.RLock, or split the "
                                "_locked helper out of the public method")
                    else:
                        add_edge(h, lk.key, func.qual, line)
            for spec, line, held in func.calls:
                callee = self._resolve_call(func, spec)
                if not callee:
                    continue
                for key, lk in self._eff_acquires(callee).items():
                    texts.setdefault(key, lk.text)
                    for h in held:
                        if h.key == key:
                            if lk.registered and lk.kind != "rlock" \
                                    and h.registered:
                                self.ctx.emit(
                                    "LC001", _at(line),
                                    f"call into {callee}() re-acquires "
                                    f"{lk.text} which is already held "
                                    "here — a non-reentrant lock "
                                    "deadlocks against itself",
                                    "pass the locked state down instead "
                                    "of re-locking, or use an RLock")
                        else:
                            add_edge(h.key, key, func.qual, line)

        # cycle detection: DFS from every node, report each cycle once
        reported: Set[Tuple[str, ...]] = set()

        def dfs(start: str, node: str, path: List[str]) -> None:
            for nxt, (qual, line) in edges.get(node, {}).items():
                if nxt == start and len(path) >= 1:
                    cyc = tuple(sorted(path))
                    if cyc in reported:
                        continue
                    reported.add(cyc)
                    order = " -> ".join(
                        texts.get(k, k) for k in path + [path[0]])
                    self.ctx.emit(
                        "LC001", _at(line),
                        f"lock-order cycle: {order} (in {qual}; another "
                        "path takes these locks in the opposite order)",
                        "pick one global order for these locks and take "
                        "them in that order everywhere")
                elif nxt not in path and nxt != start:
                    dfs(start, nxt, path + [nxt])

        for start in list(edges):
            dfs(start, start, [start])

    def _lc002(self) -> None:
        seen: Set[Tuple[int, str]] = set()
        for func in self.funcs.values():
            for desc, line, held in func.blocking:
                if held and (line, desc) not in seen:
                    seen.add((line, desc))
                    self.ctx.emit(
                        "LC002", _at(line),
                        f"blocking call {desc} while holding "
                        f"{self._held_names(held)} — every thread that "
                        "wants the lock stalls behind it",
                        "move the slow operation outside the held "
                        "region (compute under the lock, block outside)")
            for spec, line, held in func.calls:
                if not held:
                    continue
                callee = self._resolve_call(func, spec)
                if not callee:
                    continue
                for desc, via in self._eff_blocking(callee)[:1]:
                    # a condition-wait releases its own lock; calling a
                    # wait-helper while holding ONLY that condition is
                    # the normal pattern, not a block
                    if (line, desc) in seen:
                        continue
                    seen.add((line, desc))
                    where = f" in {via}" if via != callee else ""
                    self.ctx.emit(
                        "LC002", _at(line),
                        f"call into {callee}() blocks ({desc}{where}) "
                        f"while holding {self._held_names(held)}",
                        "restructure so the blocking step runs outside "
                        "the held region")

    def _lc003(self) -> None:
        for func in self.funcs.values():
            for cond, line, held, in_while, bounded in func.waits:
                others = [h for h in held if h.key != cond.key]
                if others and not bounded:
                    self.ctx.emit(
                        "LC002", _at(line),
                        f"{cond.text}.wait() releases {cond.text} but "
                        f"NOT {self._held_names(others)} — waiters on "
                        "those stall for the full wait",
                        "never wait on one condition while holding "
                        "another lock")
                if not in_while:
                    self.ctx.emit(
                        "LC003", _at(line),
                        f"{cond.text}.wait() outside a predicate while "
                        "loop — spurious and stolen wakeups make the "
                        "waiter see stale state",
                        "wrap it: `while not <predicate>: cond.wait()` "
                        "(or use cond.wait_for)")

    def _lc004(self) -> None:
        by_class: Dict[str, Dict[str, List[Tuple[str, int, bool]]]] = {}
        # methods whose every in-module call site holds a lock run in a
        # locked context even though they do not take the lock
        locked_ctx: Dict[str, bool] = {}
        callers: Dict[str, List[bool]] = {}
        for func in self.funcs.values():
            for spec, _line, held in func.calls:
                callee = self._resolve_call(func, spec)
                if callee:
                    callers.setdefault(callee, []).append(bool(held))
        for qual, flags in callers.items():
            locked_ctx[qual] = bool(flags) and all(flags)
        for func in self.funcs.values():
            if not func.cls or func.method in (
                    "__init__", "__new__", "__post_init__", "__enter__"):
                continue
            implied = (func.method.endswith("_locked")
                       or locked_ctx.get(func.qual, False))
            for attr, line, locked in func.writes:
                by_class.setdefault(func.cls, {}).setdefault(
                    attr, []).append((func.qual, line, locked or implied))
        for cls, attrs in sorted(by_class.items()):
            for attr, writes in sorted(attrs.items()):
                locked = [w for w in writes if w[2]]
                unlocked = [w for w in writes if not w[2]]
                if locked and unlocked:
                    qual, line, _ = unlocked[0]
                    lq, lline, _ = locked[0]
                    self.ctx.emit(
                        "LC004", _at(line),
                        f"self.{attr} is written under a lock in "
                        f"{lq} (line {lline}) but without one here in "
                        f"{qual} — one of the two is wrong",
                        "take the same lock here, or drop it there and "
                        "document the single-writer contract")

    def _teardown_reach(self, cls: str,
                        reg: _ClassReg) -> Tuple[List[str], Set[str]]:
        """Stop roots plus everything they call on self, transitively."""
        stop_roots = [m for m in reg.method_names if m in _STOP_NAMES]
        reachable: Set[str] = set()
        frontier = [f"{cls}.{m}" for m in stop_roots]
        while frontier:
            qual = frontier.pop()
            if qual in reachable or qual not in self.funcs:
                continue
            reachable.add(qual)
            func = self.funcs[qual]
            for spec, _line, _held in func.calls:
                callee = self._resolve_call(func, spec)
                if callee:
                    frontier.append(callee)
            # nested defs inside a reachable method count too
            for q in self.funcs:
                if q.startswith(qual + "."):
                    frontier.append(q)
        return stop_roots, reachable

    def _lc005(self) -> None:
        for cls, reg in sorted(self.mod.classes.items()):
            if not reg.thread_attrs:
                continue
            stop_roots, reachable = self._teardown_reach(cls, reg)
            joined: Set[str] = set()
            for qual in reachable:
                joined |= self.funcs[qual].joins
            for attr, line in sorted(reg.thread_attrs.items(),
                                     key=lambda kv: kv[1]):
                if attr in joined:
                    continue
                if not stop_roots:
                    self.ctx.emit(
                        "LC005", _at(line),
                        f"{cls} starts a thread on self.{attr} but has "
                        "no stop()/drain()/close() path at all — the "
                        "thread leaks past the object's lifetime",
                        "add a close() that signals the thread and "
                        "join()s it")
                else:
                    self.ctx.emit(
                        "LC005", _at(line),
                        f"{cls}.{'/'.join(sorted(stop_roots))}() never "
                        f"join()s self.{attr} — teardown returns while "
                        "the thread still runs (daemon or not, it races "
                        "interpreter shutdown and test isolation)",
                        "signal the thread to exit, then join() it on "
                        "the teardown path")

    def _lc008(self) -> None:
        for cls, reg in sorted(self.mod.classes.items()):
            if not reg.timer_attrs:
                continue
            stop_roots, reachable = self._teardown_reach(cls, reg)
            cancelled: Set[str] = set()
            for qual in reachable:
                cancelled |= self.funcs[qual].cancels
                cancelled |= self.funcs[qual].joins
            for attr, line in sorted(reg.timer_attrs.items(),
                                     key=lambda kv: kv[1]):
                if attr in cancelled:
                    continue
                if not stop_roots:
                    self.ctx.emit(
                        "LC008", _at(line),
                        f"{cls} arms a threading.Timer on self.{attr} "
                        "but has no stop()/drain()/close() path at all "
                        "— the timer fires after the object is "
                        "logically dead",
                        "add a close() that cancel()s the timer")
                else:
                    self.ctx.emit(
                        "LC008", _at(line),
                        f"{cls}.{'/'.join(sorted(stop_roots))}() never "
                        f"cancel()s self.{attr} — the armed Timer "
                        "fires after teardown and races interpreter "
                        "shutdown",
                        "cancel() the timer (and join() it if the "
                        "callback matters) on the teardown path")

    def _lc006(self) -> None:
        for func in self.funcs.values():
            for cond, line, held in func.notifies:
                if any(h.key == cond.key for h in held):
                    continue
                self.ctx.emit(
                    "LC006", _at(line),
                    f"{cond.text}.notify()/notify_all() without holding "
                    f"{cond.text} — RuntimeError at runtime (or a lost "
                    "wakeup if the lock is a foreign one)",
                    f"wrap it: `with {cond.text}: "
                    f"{cond.text}.notify_all()`")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Analyze one file's source text. Returns findings (suppressed
    lines already removed; reasonless suppressions reported as LC000)."""
    findings: List[Finding] = []
    suppressed = collect_suppressions(source, findings, path, _SUPPRESS_RE,
                                      "LC000", RULE_SEVERITY["LC000"])
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        findings.append(Finding(
            "LC000", Severity.ERROR, f"{path}:{e.lineno or 0}",
            f"syntax error: {e.msg}", ""))
        return findings
    ctx = LintContext(path=path, suppressed=suppressed,
                      severity=RULE_SEVERITY, findings=findings)
    mod = _ModuleScan(tree, ctx)
    _Analysis(mod, ctx).run()
    stale_suppression_pass(ctx, "LC007")
    sort_findings(ctx.findings)
    return ctx.findings


def lint_paths(paths: List[str]) -> List[Finding]:
    """Analyze .py files under the given files/directories."""
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_source(f.read_text(encoding="utf-8"), str(f)))
    return findings


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def self_check(report=print) -> int:
    """Every rule's bad fixture fires exactly that rule; every good twin
    is clean. 0 when all hold, 1 otherwise."""
    from deeplearning4j_tpu_torch.analysis.fixtures import LC_FIXTURES
    failures = []
    for rule, (bad, good) in sorted(LC_FIXTURES.items()):
        got = [f.rule for f in lint_source(bad, f"<{rule}-bad>")]
        if got != [rule]:
            failures.append(f"{rule}: bad fixture fired {got or 'nothing'}, "
                            f"expected [{rule}]")
        got = [f.rule for f in lint_source(good, f"<{rule}-good>")]
        if got:
            failures.append(f"{rule}: good fixture fired {got}")
    missing = set(RULES) - set(LC_FIXTURES) - {"LC000"}  # LC000 = meta rule
    if missing:
        failures.append(f"rules without fixtures: {sorted(missing)}")
    if failures:
        report("lockcheck --self-check FAILED:")
        for f in failures:
            report("  " + f)
        return 1
    report(f"lockcheck --self-check: {len(LC_FIXTURES)} rule fixtures OK")
    return 0


def main(argv=None) -> int:
    import argparse
    from pathlib import Path
    from deeplearning4j_tpu_torch.analysis.findings import format_findings
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis.lockcheck",
        description="Concurrency analysis of the threaded host code.")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files / directories to analyze (default: the "
                         "port's package)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--self-check", action="store_true",
                    help="analyze the per-rule fixtures and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, (slug, desc) in sorted(RULES.items()):
            print(f"{rule}  {slug:<22} {RULE_SEVERITY[rule]:<8} {desc}")
        return 0
    if args.self_check:
        return self_check()
    findings = lint_paths(args.paths or [
        str(Path(__file__).resolve().parent.parent)])
    if findings:
        print(format_findings(findings, header="lockcheck findings:"))
        return 1
    print("lockcheck: clean")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
