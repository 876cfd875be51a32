"""Concurrency verifier: whole-repo lock-order graph + blocking-under-lock
+ unguarded shared state (port of
``cosmos_curate_tpu/analysis/concurrency_check.py``).

The curate-lint pillar after the AST rules and the graph linter, run as
``cosmos-curate-tpu-torch lint --concurrency``. Unlike the
per-file AST rules this is a *whole-repo* pass: lock identity and
acquisition order only mean something across files, so the checker first
builds a registry of every ``threading.Lock``/``RLock``/``Condition``
attribute in the tree and then analyzes every function against it.

Three rule ids, all suppressible with the usual
``# curate-lint: disable=<rule>`` comments:

``lock-order``
    Cycles in the acquisition-order graph (potential deadlock), and
    re-acquisition of a held non-reentrant ``Lock`` (certain deadlock).
    Edges come from nested ``with`` statements and, interprocedurally,
    from same-class methods called while a lock is held (bounded depth).
    A ``Condition(self._lock)`` aliases the lock it wraps — ``with
    self._work_cv:`` IS ``with self._lock:`` for ordering purposes.

``lock-blocking``
    A blocking call made while a registered lock is held: ``os.fsync``,
    ``time.sleep``, ``subprocess.*``, socket ``accept/recv*/sendall``,
    blocking ``queue.put/get``, thread/process ``.join()``, ``.wait()``
    on a *different* lock's condition/event, and jit-dispatch calls
    (reusing the sync-readback rule's jit-name tracking). Every thread
    queued behind the lock stalls for the full duration of the call.

``unguarded-shared``
    Shared attributes with inconsistent guarding, in classes that start
    threads. ``# guarded-by: <lock>`` on the attribute's initialization
    declares intent: every mutation outside ``__init__`` must then hold
    that lock. Without an annotation a majority heuristic applies: an
    attribute mutated both from a thread-target context and elsewhere,
    where most mutation sites hold a lock but some do not, flags the
    unguarded sites. (Files under ``engine/`` keep the stricter
    ``lock-discipline`` rule for the heuristic half; the declared
    ``guarded-by`` contract is enforced everywhere.)

Library entry points: :func:`run_concurrency_check` (the CLI path),
:func:`analyze` (returns the full :class:`RepoAnalysis` — registry, order
edges, findings — used by the runtime sanitizer's cross-validation and by
tests).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Sequence

from cosmos_curate_tpu_torch.analysis.common import (
    Finding,
    LintConfig,
    Severity,
    is_suppressed,
    load_config,
    parse_suppressions,
)

RULE_ORDER = "lock-order"
RULE_BLOCKING = "lock-blocking"
RULE_UNGUARDED = "unguarded-shared"

# Interprocedural expansion depth: a() -> b() -> c() is followed this many
# call hops when propagating acquired-lock sets and blocking calls.
MAX_CALL_DEPTH = 3

_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*(?P<lock>[\w.]+)")
# ``# holds-lock: _lock, _prefix_lock`` on (or above) a ``def`` declares the
# caller-must-hold contract (clang REQUIRES()): the body is analyzed with
# those locks held, and every same-class call site is checked to hold them.
_HOLDS_LOCK_RE = re.compile(r"#\s*holds-lock:\s*(?P<locks>[\w.,\s]+)")

_LOCK_CTORS = {"Lock": False, "RLock": True, "Condition": True, "Semaphore": False,
               "BoundedSemaphore": False}

# receiver-name hints for blocking queue.put/.get (a bare ``.get`` is every
# dict in the repo; require the receiver to look like a queue)
_QUEUEISH = re.compile(r"(^q$|queue$|_q$)", re.IGNORECASE)
_JOINABLE = re.compile(r"(thread|proc|worker|agent)", re.IGNORECASE)

_SOCKET_BLOCKERS = {"accept", "recv", "recvfrom", "recv_into", "sendall"}

# Construction-phase methods: mutations here happen-before any worker
# thread exists (the same exemption lock-discipline gives __init__).
_INIT_PHASE_METHODS = {"__init__", "__post_init__", "setup", "build"}
_SUBPROCESS_BLOCKERS = {"run", "Popen", "call", "check_call", "check_output",
                        "communicate"}


# ---------------------------------------------------------------------------
# registry


@dataclass(frozen=True)
class LockDecl:
    """One registered lock. ``key`` is ``ClassName._attr`` for instance /
    class attributes and ``<module_stem>._NAME`` for module globals."""

    key: str
    file: str
    line: int
    ctor: str  # Lock | RLock | Condition | ...
    reentrant: bool
    alias_of: str | None = None  # Condition(self._lock) aliases that key


class LockRegistry:
    def __init__(self) -> None:
        self.decls: dict[str, LockDecl] = {}

    def add(self, decl: LockDecl) -> None:
        # first declaration wins (a lock re-created in a reset() method is
        # still the same logical lock)
        self.decls.setdefault(decl.key, decl)

    def root(self, key: str) -> str:
        """Follow Condition-aliasing to the underlying lock's key."""
        seen = set()
        while key in self.decls and self.decls[key].alias_of and key not in seen:
            seen.add(key)
            key = self.decls[key].alias_of  # type: ignore[assignment]
        return key

    def reentrant(self, key: str) -> bool:
        root = self.root(key)
        decl = self.decls.get(root)
        return decl.reentrant if decl else True

    def by_site(self) -> dict[tuple[str, int], str]:
        """(file, line) of the constructor call -> key; joins the runtime
        sanitizer's creation-site lock names back onto static keys."""
        return {(d.file, d.line): d.key for d in self.decls.values()}


# ---------------------------------------------------------------------------
# per-function facts


@dataclass
class _Acquire:
    key: str
    held: tuple[str, ...]  # root keys held at this acquisition, in order
    line: int


@dataclass
class _Blocking:
    desc: str
    held: tuple[str, ...]
    line: int


@dataclass
class _Call:
    callee: str  # bare self-method / module-function name
    held: tuple[str, ...]
    line: int


@dataclass
class _Mutation:
    attr: str
    method: str
    line: int
    held: tuple[str, ...]
    kind: str  # "store" | "mutator"


@dataclass
class FuncFacts:
    qualname: str  # "Class.method" or "function"
    acquires: list[_Acquire] = field(default_factory=list)
    blocking: list[_Blocking] = field(default_factory=list)
    calls: list[_Call] = field(default_factory=list)
    # holds-lock contract: root keys the caller must hold (analysis seeds
    # the held set with these; call sites are verified)
    requires: tuple[str, ...] = ()
    def_line: int = 0


@dataclass
class ClassFacts:
    name: str
    file: str
    methods: dict[str, FuncFacts] = field(default_factory=dict)
    mutations: list[_Mutation] = field(default_factory=list)
    # attr -> (lock key, decl line) from ``# guarded-by:`` comments
    guarded_by: dict[str, tuple[str, int]] = field(default_factory=dict)
    starts_threads: bool = False
    thread_targets: set[str] = field(default_factory=set)
    safe_attrs: set[str] = field(default_factory=set)
    call_graph: dict[str, set[str]] = field(default_factory=dict)


@dataclass
class ModuleFacts:
    rel_path: str
    stem: str
    classes: dict[str, ClassFacts] = field(default_factory=dict)
    functions: dict[str, FuncFacts] = field(default_factory=dict)


@dataclass
class OrderEdge:
    src: str
    dst: str
    file: str
    line: int
    via: str  # "" for a direct nested with, else the call chain


@dataclass
class RepoAnalysis:
    registry: LockRegistry
    edges: list[OrderEdge]
    findings: list[Finding]

    def edge_set(self) -> set[tuple[str, str]]:
        return {(e.src, e.dst) for e in self.edges}


# ---------------------------------------------------------------------------
# AST helpers (shared vocabulary with rules/lock_discipline.py, kept local
# so the whole-repo pass has no per-file-rule dependencies)

_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "add", "discard", "appendleft", "popleft",
}

_THREAD_SAFE_TYPES = {
    "Event", "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "Barrier", "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "local",
}


def _self_attr(node: ast.expr) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id in ("self", "cls")
    ):
        return node.attr
    return None


def _self_rooted_base(node: ast.expr) -> str | None:
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        direct = _self_attr(node)
        if direct is not None:
            return direct
        node = node.value
    return None


def _dotted_final(node: ast.expr) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _receiver_name(func: ast.expr) -> str | None:
    """``self.x.put`` -> 'x', ``q.put`` -> 'q'."""
    if not isinstance(func, ast.Attribute):
        return None
    base = func.value
    direct = _self_attr(base)
    if direct is not None:
        return direct
    if isinstance(base, ast.Name):
        return base.id
    return _dotted_final(base)


def _lock_ctor(call: ast.expr) -> tuple[str, ast.Call] | None:
    """``threading.Lock()`` / bare ``Lock()`` -> (ctor name, call node)."""
    if not isinstance(call, ast.Call):
        return None
    name = _dotted_final(call.func)
    if name in _LOCK_CTORS:
        return name, call
    return None


def _collect_jit_names(tree: ast.Module) -> set[str]:
    from cosmos_curate_tpu_torch.analysis.rules import sync_readback

    return sync_readback._collect_jit_names(tree)


def _is_unbounded_queue_ctor(value: ast.expr) -> bool:
    """``queue.Queue()`` / ``mp.Queue()`` with no maxsize (or 0/negative):
    ``put()`` on the instance never blocks."""
    if not isinstance(value, ast.Call) or _dotted_final(value.func) not in (
        "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue", "deque",
    ):
        return False
    size: ast.expr | None = value.args[0] if value.args else None
    for kw in value.keywords:
        if kw.arg == "maxsize":
            size = kw.value
    if size is None:
        return True
    return isinstance(size, ast.Constant) and isinstance(size.value, int) and size.value <= 0


def _timeout_is_zero(node: ast.Call) -> bool:
    t: ast.expr | None = node.args[0] if node.args else None
    for kw in node.keywords:
        if kw.arg == "timeout":
            t = kw.value
    return isinstance(t, ast.Constant) and t.value == 0


def _parse_holds_lock(
    def_line: int, source_lines: list[str], cls_name: str | None, reg: LockRegistry
) -> tuple[str, ...]:
    """The holds-lock contract on the ``def`` line or the line above it,
    resolved to registered root keys (unknown names kept verbatim so the
    checker can flag the typo)."""
    for line_no in (def_line, def_line - 1):
        if not (1 <= line_no <= len(source_lines)):
            continue
        m = _HOLDS_LOCK_RE.search(source_lines[line_no - 1])
        if not m:
            continue
        out = []
        for name in (n.strip() for n in m.group("locks").split(",")):
            if not name:
                continue
            key = name if "." in name else (f"{cls_name}.{name}" if cls_name else name)
            out.append(reg.root(key))
        return tuple(out)
    return ()


_JIT_HOLDER_CONVENTION = re.compile(r"^_(jitted\w*|apply|sample)$")


# ---------------------------------------------------------------------------
# registry construction


def _register_module_locks(mod: ModuleFacts, tree: ast.Module, reg: LockRegistry) -> None:
    for node in tree.body:
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        ctor = _lock_ctor(value) if value is not None else None
        if ctor is None:
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                reg.add(
                    LockDecl(
                        key=f"{mod.stem}.{t.id}",
                        file=mod.rel_path,
                        line=value.lineno,
                        ctor=ctor[0],
                        reentrant=_LOCK_CTORS[ctor[0]],
                    )
                )


def _register_class_locks(
    mod: ModuleFacts, cls: ast.ClassDef, reg: LockRegistry
) -> None:
    def add(attr: str, ctor: str, call: ast.Call) -> None:
        alias = None
        if ctor == "Condition" and call.args:
            aliased = _self_attr(call.args[0])
            if aliased is not None:
                alias = f"{cls.name}.{aliased}"
        reg.add(
            LockDecl(
                key=f"{cls.name}.{attr}",
                file=mod.rel_path,
                line=call.lineno,
                ctor=ctor,
                reentrant=_LOCK_CTORS[ctor],
                alias_of=alias,
            )
        )

    # class-level attributes (shared_engine's registry-wide class lock)
    for item in cls.body:
        if isinstance(item, (ast.Assign, ast.AnnAssign)):
            value = item.value
            ctor = _lock_ctor(value) if value is not None else None
            if ctor is None:
                continue
            targets = item.targets if isinstance(item, ast.Assign) else [item.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    add(t.id, ctor[0], ctor[1])
    # instance attributes assigned in any method (usually __init__)
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(item):
            if not isinstance(node, ast.Assign):
                continue
            ctor = _lock_ctor(node.value)
            if ctor is None:
                continue
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    add(attr, ctor[0], ctor[1])


# ---------------------------------------------------------------------------
# function-body analysis


class _FuncScanner:
    """Walk one function body tracking the ordered set of held locks."""

    def __init__(
        self,
        facts: FuncFacts,
        reg: LockRegistry,
        mod: ModuleFacts,
        cls_name: str | None,
        jit_names: set[str],
        unbounded_queues: set[str] | None = None,
    ) -> None:
        self.facts = facts
        self.reg = reg
        self.mod = mod
        self.cls_name = cls_name
        self.jit_names = jit_names
        # attribute names known to be unbounded queue.Queue / mp.Queue
        # instances (put() on them never blocks); locals join during scan
        self.unbounded = set(unbounded_queues or ())

    # -- lock-expression resolution
    def resolve(self, expr: ast.expr) -> str | None:
        """Map a with-item / receiver expression to a registered lock key
        (pre-aliasing), or None."""
        if isinstance(expr, ast.Call):
            expr = expr.func  # with self._lock.acquire_timeout(...) style
        attr = _self_attr(expr)
        if attr is not None and self.cls_name:
            key = f"{self.cls_name}.{attr}"
            if key in self.reg.decls:
                return key
        if isinstance(expr, ast.Name):
            key = f"{self.mod.stem}.{expr.id}"
            if key in self.reg.decls:
                return key
        if isinstance(expr, ast.Attribute):
            # ClassName._lock (class attribute referenced by name)
            base = expr.value
            if isinstance(base, ast.Name):
                key = f"{base.id}.{expr.attr}"
                if key in self.reg.decls:
                    return key
        return None

    # -- entry
    def scan(self, body: Iterable[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt, held=self.facts.requires)

    def _stmt(self, node: ast.AST, held: tuple[str, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs are analyzed on their own (closures: best effort)
        if isinstance(node, ast.Assign) and _is_unbounded_queue_ctor(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.unbounded.add(t.id)
        if isinstance(node, ast.With):
            inner = held
            for item in node.items:
                key = self.resolve(item.context_expr)
                if key is not None:
                    root = self.reg.root(key)
                    self.facts.acquires.append(_Acquire(root, inner, item.context_expr.lineno))
                    if root not in inner:
                        inner = inner + (root,)
                else:
                    self._expr(item.context_expr, held=inner)
            for stmt in node.body:
                self._stmt(stmt, held=inner)
            return
        for child in ast.iter_child_nodes(node):
            self._expr_or_stmt(child, held)

    def _expr_or_stmt(self, node: ast.AST, held: tuple[str, ...]) -> None:
        if isinstance(node, ast.Call):
            self._call(node, held)
        self._stmt(node, held)

    def _expr(self, node: ast.AST, held: tuple[str, ...]) -> None:
        for child in ast.walk(node):
            if isinstance(child, ast.Call):
                self._call(child, held)

    # -- calls
    def _call(self, node: ast.Call, held: tuple[str, ...]) -> None:
        func = node.func
        attr = func.attr if isinstance(func, ast.Attribute) else None
        recv = _receiver_name(func)

        # explicit .acquire(): an order observation (no scope tracking)
        if attr == "acquire" and isinstance(func, ast.Attribute):
            key = self.resolve(func.value)
            if key is not None:
                self.facts.acquires.append(
                    _Acquire(self.reg.root(key), held, node.lineno)
                )
                return

        # self-call graph edge (interprocedural order + blocking)
        callee = _self_attr(func)
        if callee is not None and self.cls_name:
            self.facts.calls.append(_Call(callee, held, node.lineno))
        elif isinstance(func, ast.Name) and func.id in self.mod.functions:
            self.facts.calls.append(_Call(func.id, held, node.lineno))

        desc = self._blocking_desc(node, func, attr, recv, held)
        if desc is not None:
            self.facts.blocking.append(_Blocking(desc, held, node.lineno))

    def _blocking_desc(
        self,
        node: ast.Call,
        func: ast.expr,
        attr: str | None,
        recv: str | None,
        held: tuple[str, ...],
    ) -> str | None:
        # recorded even with nothing held locally: a caller may hold a lock
        # across a call into this function (the interprocedural report)
        if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            owner = func.value.id
            if owner == "os" and attr in ("fsync", "fdatasync"):
                return f"os.{attr}()"
            if owner == "time" and attr == "sleep":
                return "time.sleep()"
            if owner == "subprocess" and attr in _SUBPROCESS_BLOCKERS:
                return f"subprocess.{attr}()"
            if owner == "shutil" and attr in ("copy", "copy2", "copytree", "move"):
                return f"shutil.{attr}()"
        if attr in _SOCKET_BLOCKERS:
            return f".{attr}() (socket)"
        if attr in ("put", "get") and recv and _QUEUEISH.search(recv):
            if attr == "put" and recv in self.unbounded:
                return None  # unbounded queue: put() cannot block
            if not any(
                kw.arg == "block" and isinstance(kw.value, ast.Constant)
                and kw.value.value is False
                for kw in node.keywords
            ):
                return f"blocking {recv}.{attr}()"
        if attr == "join" and recv and _JOINABLE.search(recv):
            if _timeout_is_zero(node):
                return None  # join(timeout=0) is a non-blocking reap
            return f"{recv}.join()"
        if attr == "wait" and isinstance(func, ast.Attribute):
            # waiting on a cv/event while holding an UNRELATED lock: the cv
            # releases only its own lock, anything else stays held for the
            # whole wait. (Held-gated here: without local context we cannot
            # tell a cv's own lock from a stranger's, so this one is not
            # propagated interprocedurally.)
            key = self.resolve(func.value)
            own_root = self.reg.root(key) if key else None
            others = [h for h in held if h != own_root]
            if others and (key is not None or (recv or "").endswith(("_cv", "_event", "_evt"))):
                return f"{recv}.wait() while holding {', '.join(others)}"
            return None
        # jit dispatch under a lock serializes every waiter behind device
        # compute (sync-readback's jit-name tracking, same convention)
        name = _dotted_final(func)
        if name and (name in self.jit_names or _JIT_HOLDER_CONVENTION.match(name)):
            return f"jit dispatch {name}(...)"
        return None


# ---------------------------------------------------------------------------
# class-body analysis (mutations for unguarded-shared)


class _MutationScanner:
    def __init__(
        self,
        cls_facts: ClassFacts,
        scanner: _FuncScanner,
        method: str,
    ) -> None:
        self.cf = cls_facts
        self.scanner = scanner
        self.method = method

    def scan(self, body: Iterable[ast.stmt], held: tuple[str, ...] = ()) -> None:
        for stmt in body:
            self._stmt(stmt, held=held)

    def _stmt(self, node: ast.AST, held: tuple[str, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(node, ast.With):
            inner = held
            for item in node.items:
                key = self.scanner.resolve(item.context_expr)
                if key is not None:
                    root = self.scanner.reg.root(key)
                    if root not in inner:
                        inner = inner + (root,)
            for stmt in node.body:
                self._stmt(stmt, held=inner)
            return
        self._record(node, held)
        for child in ast.iter_child_nodes(node):
            self._stmt(child, held)

    def _record(self, node: ast.AST, held: tuple[str, ...]) -> None:
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = list(node.targets)
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and node.func.attr in _MUTATORS:
                base = _self_rooted_base(node.func.value)
                if base is not None:
                    self.cf.mutations.append(
                        _Mutation(base, self.method, node.lineno, held, "mutator")
                    )
            return
        for t in targets:
            for el in t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]:
                attr = _self_rooted_base(el)
                if attr is not None:
                    self.cf.mutations.append(
                        _Mutation(attr, self.method, getattr(node, "lineno", 0), held, "store")
                    )


def _scan_class(
    mod: ModuleFacts,
    cls: ast.ClassDef,
    reg: LockRegistry,
    jit_names: set[str],
    source_lines: list[str],
) -> ClassFacts:
    cf = ClassFacts(cls.name, mod.rel_path)
    unbounded: set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        if node.value is None or not _is_unbounded_queue_ctor(node.value):
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                unbounded.add(attr)
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        ff = FuncFacts(
            f"{cls.name}.{item.name}",
            requires=_parse_holds_lock(item.lineno, source_lines, cls.name, reg),
            def_line=item.lineno,
        )
        scanner = _FuncScanner(ff, reg, mod, cls.name, jit_names, unbounded)
        scanner.scan(item.body)
        cf.methods[item.name] = ff
        cf.call_graph[item.name] = {c.callee for c in ff.calls}
        _MutationScanner(cf, scanner, item.name).scan(item.body, held=ff.requires)
        for node in ast.walk(item):
            if isinstance(node, ast.Call) and _dotted_final(node.func) == "Thread":
                cf.starts_threads = True
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = _self_attr(kw.value)
                        if target is not None:
                            cf.thread_targets.add(target)
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                ctor = _dotted_final(node.value.func)
                if ctor in _THREAD_SAFE_TYPES:
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is not None:
                            cf.safe_attrs.add(attr)
    # guarded-by annotations: the comment sits on the line of an attribute
    # assignment anywhere in the class body
    for item in ast.walk(cls):
        if not isinstance(item, (ast.Assign, ast.AnnAssign)):
            continue
        line_no = getattr(item, "lineno", 0)
        if not (1 <= line_no <= len(source_lines)):
            continue
        m = _GUARDED_BY_RE.search(source_lines[line_no - 1])
        if not m:
            continue
        lock_name = m.group("lock")
        key = lock_name if "." in lock_name else f"{cls.name}.{lock_name}"
        targets = item.targets if isinstance(item, ast.Assign) else [item.target]
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                cf.guarded_by[attr] = (key, line_no)
    return cf


def _scan_module(path: Path, rel: str, reg_only: bool, reg: LockRegistry) -> tuple[ModuleFacts | None, ast.Module | None, str]:
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
    except (OSError, UnicodeDecodeError, SyntaxError):
        return None, None, ""
    mod = ModuleFacts(rel_path=rel, stem=path.stem)
    _register_module_locks(mod, tree, reg)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            _register_class_locks(mod, node, reg)
    return mod, tree, source


# ---------------------------------------------------------------------------
# interprocedural expansion


def _transitive(
    start: str,
    call_graph: dict[str, set[str]],
    per_method: dict[str, set],
    depth: int = MAX_CALL_DEPTH,
) -> set:
    """Union ``per_method`` values over calls reachable from ``start``
    within ``depth`` hops (including start itself)."""
    out: set = set(per_method.get(start, ()))
    frontier = {start}
    seen = {start}
    for _ in range(depth):
        nxt: set[str] = set()
        for m in frontier:
            for callee in call_graph.get(m, ()):
                if callee not in seen:
                    seen.add(callee)
                    nxt.add(callee)
                    out |= per_method.get(callee, set())
        if not nxt:
            break
        frontier = nxt
    return out


# ---------------------------------------------------------------------------
# the pass


def _iter_files(paths: Sequence[str | Path], exclude: Sequence[str]) -> list[Path]:
    from cosmos_curate_tpu_torch.analysis.ast_lint import iter_python_files

    return iter_python_files(paths, exclude)


def analyze(
    paths: Sequence[str | Path],
    config: LintConfig | None = None,
) -> RepoAnalysis:
    config = config or load_config()
    from cosmos_curate_tpu_torch.analysis.ast_lint import _repo_root, _rel

    root = _repo_root()
    files = _iter_files(paths, config.exclude)

    reg = LockRegistry()
    parsed: list[tuple[ModuleFacts, ast.Module, str]] = []
    # pass 1: registry over every file (order edges in file A may involve
    # locks declared in file B)
    for f in files:
        rel = _rel(f, root)
        mod, tree, source = _scan_module(f, rel, reg_only=True, reg=reg)
        if mod is not None and tree is not None:
            parsed.append((mod, tree, source))

    # pass 2: per-function facts against the complete registry
    edges: list[OrderEdge] = []
    findings: list[Finding] = []
    suppressions: dict[str, tuple[dict[int, set[str]], set[str]]] = {}
    for mod, tree, source in parsed:
        lines = source.splitlines()
        jit_names = _collect_jit_names(tree)
        # module-level functions first (so _FuncScanner sees them as callees)
        fn_nodes = [
            n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for n in fn_nodes:
            mod.functions[n.name] = FuncFacts(
                n.name,
                requires=_parse_holds_lock(n.lineno, lines, None, reg),
                def_line=n.lineno,
            )
        for n in fn_nodes:
            scanner = _FuncScanner(mod.functions[n.name], reg, mod, None, jit_names)
            scanner.scan(n.body)
        for n in tree.body:
            if isinstance(n, ast.ClassDef):
                mod.classes[n.name] = _scan_class(mod, n, reg, jit_names, lines)

        mod_findings = _module_findings(mod, reg, edges)
        per_line, file_wide = parse_suppressions(source)
        suppressions[mod.rel_path] = (per_line, file_wide)
        findings.extend(
            f for f in mod_findings if not is_suppressed(f, per_line, file_wide)
        )

    for f in _cycle_findings(edges, reg):
        per_line, file_wide = suppressions.get(f.file, ({}, set()))
        if not is_suppressed(f, per_line, file_wide):
            findings.append(f)
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return RepoAnalysis(registry=reg, edges=edges, findings=findings)


def _module_findings(
    mod: ModuleFacts, reg: LockRegistry, edges: list[OrderEdge]
) -> list[Finding]:
    findings: list[Finding] = []

    def group_facts(
        funcs: dict[str, FuncFacts], call_graph: dict[str, set[str]]
    ) -> None:
        acq_sets = {
            name: {a.key for a in ff.acquires} for name, ff in funcs.items()
        }
        blocking_sets = {
            name: {(b.desc, b.line) for b in ff.blocking} for name, ff in funcs.items()
        }
        for name, ff in funcs.items():
            # direct order edges + non-reentrant re-acquire
            for a in ff.acquires:
                for h in a.held:
                    if h == a.key:
                        continue
                    edges.append(OrderEdge(h, a.key, mod.rel_path, a.line, ""))
                if a.key in a.held and not reg.reentrant(a.key):
                    findings.append(
                        Finding(
                            mod.rel_path, a.line, RULE_ORDER,
                            f"re-acquiring non-reentrant lock {a.key} while "
                            "already held: guaranteed self-deadlock",
                        )
                    )
            # direct blocking-under-lock (held-gated; lock-free blocking
            # calls are only reported through a lock-holding caller below)
            for b in ff.blocking:
                if not b.held:
                    continue
                findings.append(
                    Finding(
                        mod.rel_path, b.line, RULE_BLOCKING,
                        f"{b.desc} while holding {', '.join(b.held)}: every "
                        "thread queued on the lock stalls for the call's "
                        "full duration",
                    )
                )
            # holds-lock contract verification: a same-group call into a
            # method that declares requirements must already hold them
            for c in ff.calls:
                callee_ff = funcs.get(c.callee)
                if callee_ff is None:
                    continue
                for req in callee_ff.requires:
                    if req not in c.held:
                        findings.append(
                            Finding(
                                mod.rel_path, c.line, RULE_UNGUARDED,
                                f"call to {c.callee}() (holds-lock: {req} at "
                                f"line {callee_ff.def_line}) without holding "
                                f"{req}",
                            )
                        )
            # interprocedural: locks/blocking reachable through calls made
            # while something is held
            for c in ff.calls:
                if not c.held:
                    continue
                reached = _transitive(c.callee, call_graph, acq_sets)
                for lock in sorted(reached):
                    if lock in c.held:
                        if not reg.reentrant(lock):
                            findings.append(
                                Finding(
                                    mod.rel_path, c.line, RULE_ORDER,
                                    f"call to {c.callee}() re-acquires "
                                    f"non-reentrant {lock} already held here: "
                                    "guaranteed self-deadlock",
                                )
                            )
                        continue
                    for h in c.held:
                        edges.append(
                            OrderEdge(h, lock, mod.rel_path, c.line, f"via {c.callee}()")
                        )
                reached_blocking = _transitive(c.callee, call_graph, blocking_sets)
                for desc, _bline in sorted(reached_blocking):
                    findings.append(
                        Finding(
                            mod.rel_path, c.line, RULE_BLOCKING,
                            f"call to {c.callee}() reaches {desc} while "
                            f"holding {', '.join(c.held)}",
                        )
                    )

    mod_call_graph = {
        name: {c.callee for c in ff.calls} for name, ff in mod.functions.items()
    }
    group_facts(mod.functions, mod_call_graph)
    for cls in mod.classes.values():
        group_facts(cls.methods, cls.call_graph)
        findings.extend(_unguarded_findings(mod, cls, reg))
    return findings


def _unguarded_findings(
    mod: ModuleFacts, cls: ClassFacts, reg: LockRegistry
) -> list[Finding]:
    findings: list[Finding] = []
    by_attr: dict[str, list[_Mutation]] = {}
    for m in cls.mutations:
        if m.method in _INIT_PHASE_METHODS or m.attr in cls.safe_attrs:
            continue
        by_attr.setdefault(m.attr, []).append(m)

    # declared contracts are enforced everywhere
    for attr, (lock_key, decl_line) in cls.guarded_by.items():
        root = reg.root(lock_key)
        if lock_key not in reg.decls:
            findings.append(
                Finding(
                    mod.rel_path, decl_line, RULE_UNGUARDED,
                    f"guarded-by names unknown lock '{lock_key}' "
                    f"(registered: class locks of {cls.name})",
                )
            )
            continue
        for m in by_attr.get(attr, []):
            if root not in m.held:
                findings.append(
                    Finding(
                        mod.rel_path, m.line, RULE_UNGUARDED,
                        f"self.{attr} is declared guarded-by {lock_key} but "
                        f"{cls.name}.{m.method} mutates it without holding it",
                    )
                )

    # heuristic half only for thread-starting classes, and not under
    # engine/ where the stricter lock-discipline rule owns the territory
    if not cls.starts_threads or "engine/" in mod.rel_path.replace("\\", "/"):
        return findings
    thread_reach = _thread_reachable(cls)
    for attr, muts in sorted(by_attr.items()):
        if attr in cls.guarded_by:
            continue
        guarded = [m for m in muts if m.held]
        unguarded = [m for m in muts if not m.held]
        if not guarded or not unguarded:
            continue
        in_thread = any(m.method in thread_reach for m in muts)
        outside = any(m.method not in thread_reach for m in muts)
        if not (in_thread and outside):
            continue
        if len(guarded) <= len(unguarded):
            continue  # majority must be guarded for intent to be inferable
        locks = {h for m in guarded for h in m.held}
        hint = sorted(locks)[0] if locks else "?"
        for m in unguarded:
            findings.append(
                Finding(
                    mod.rel_path, m.line, RULE_UNGUARDED,
                    f"self.{attr} is mutated under {hint} at "
                    f"{len(guarded)} site(s) but {cls.name}.{m.method} "
                    "mutates it lock-free; guard it or declare intent with "
                    f"'# guarded-by: {hint.split('.', 1)[-1]}' on its init",
                )
            )
    return findings


def _thread_reachable(cls: ClassFacts) -> set[str]:
    seen: set[str] = set()
    stack = list(cls.thread_targets)
    while stack:
        m = stack.pop()
        if m in seen:
            continue
        seen.add(m)
        stack.extend(cls.call_graph.get(m, ()))
    return seen


# ---------------------------------------------------------------------------
# cycles


def _cycle_findings(edges: list[OrderEdge], reg: LockRegistry) -> list[Finding]:
    graph: dict[str, set[str]] = {}
    example: dict[tuple[str, str], OrderEdge] = {}
    for e in edges:
        if e.src == e.dst:
            continue
        graph.setdefault(e.src, set()).add(e.dst)
        graph.setdefault(e.dst, set())
        example.setdefault((e.src, e.dst), e)

    sccs = _tarjan(graph)
    findings: list[Finding] = []
    for comp in sccs:
        if len(comp) < 2:
            continue
        nodes = sorted(comp)
        sites = []
        for a, b in sorted(example):
            if a in comp and b in comp:
                e = example[(a, b)]
                via = f" {e.via}" if e.via else ""
                sites.append(f"{a}->{b} at {e.file}:{e.line}{via}")
        anchor = min(
            (example[(a, b)] for a, b in example if a in comp and b in comp),
            key=lambda e: (e.file, e.line),
        )
        findings.append(
            Finding(
                anchor.file, anchor.line, RULE_ORDER,
                "lock acquisition-order cycle (potential deadlock) between "
                f"{', '.join(nodes)}: {'; '.join(sites)} — pick one canonical "
                "order and document it at the lock declarations",
            )
        )
    return findings


def _tarjan(graph: dict[str, set[str]]) -> list[set[str]]:
    """Iterative Tarjan SCC (the repo is small but recursion limits are
    not worth tripping in a linter)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[set[str]] = []
    counter = [0]

    for start in graph:
        if start in index:
            continue
        work: list[tuple[str, Iterable[str]]] = [(start, iter(graph[start]))]
        index[start] = low[start] = counter[0]
        counter[0] += 1
        stack.append(start)
        on_stack.add(start)
        while work:
            node, it = work[-1]
            advanced = False
            for nbr in it:
                if nbr not in index:
                    index[nbr] = low[nbr] = counter[0]
                    counter[0] += 1
                    stack.append(nbr)
                    on_stack.add(nbr)
                    work.append((nbr, iter(graph[nbr])))
                    advanced = True
                    break
                if nbr in on_stack:
                    low[node] = min(low[node], index[nbr])
            if advanced:
                continue
            work.pop()
            if low[node] == index[node]:
                comp: set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.add(w)
                    if w == node:
                        break
                sccs.append(comp)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return sccs


# ---------------------------------------------------------------------------
# entry point


def run_concurrency_check(
    paths: Sequence[str | Path],
    config: LintConfig | None = None,
) -> list[Finding]:
    """The ``lint --concurrency`` pass: returns surviving findings."""
    return analyze(paths, config).findings
