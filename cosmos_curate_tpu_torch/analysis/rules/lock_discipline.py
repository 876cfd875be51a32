"""lock-discipline: thread-shared attribute mutated outside its lock.

The hazard class this encodes is the one the engine's control plane lives
one edit away from (engine/remote_plane.py, engine/remote_agent.py,
engine/object_channel.py): a class starts ``threading.Thread`` workers and
mutates ``self`` attributes from more than one thread, but only some of the
mutation sites hold ``self._lock``.

Two heuristics, both reported under this rule id, applied only to classes
that start threads in files under ``engine/``:

1. *inconsistent guard*: an attribute is mutated both inside and outside a
   ``with self._lock:`` block (``__init__`` is exempt — construction happens
   before any thread exists).
2. *cross-thread unguarded*: an attribute is mutated without a lock in a
   thread-reachable method (a ``Thread(target=self.X)`` target, or a method
   it transitively calls) while also being mutated from the main context or
   a different thread target — or the thread target is spawned inside a
   loop (one instance per connection/request), making the method concurrent
   with itself.

Attributes holding thread-safe primitives (assigned ``threading.Event()``,
``Lock()``, ``queue.Queue()`` etc. in ``__init__``) are exempt: calling
``.set()``/``.clear()`` on an Event is their intended cross-thread use.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from cosmos_curate_tpu_torch.analysis.common import Finding
from cosmos_curate_tpu_torch.analysis.rules import Rule, RuleContext

# Method names that mutate their receiver in place.
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "add", "discard", "appendleft", "popleft",
    "sort", "reverse",
}

# Constructors whose instances are safe to poke from any thread.
_THREAD_SAFE_TYPES = {
    "Event", "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "Barrier", "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
}

_LOCKISH = ("lock", "mutex", "cond")


def _dotted_final(node: ast.expr) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _self_attr(node: ast.expr) -> str | None:
    """``self.X`` -> 'X'."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _self_rooted_base(node: ast.expr) -> str | None:
    """Leftmost ``self.X`` under subscripts/attribute chains:
    ``self.X[k]``, ``self.X.y`` -> 'X'."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        direct = _self_attr(node)
        if direct is not None:
            return direct
        node = node.value
    return None


@dataclass
class _Mutation:
    attr: str
    method: str
    lineno: int
    in_lock: bool


@dataclass
class _ClassFacts:
    name: str
    starts_threads: bool = False
    # thread-target method name -> spawned inside a loop (multi-instance)
    targets: dict[str, bool] = field(default_factory=dict)
    calls: dict[str, set[str]] = field(default_factory=dict)  # self-call graph
    mutations: list[_Mutation] = field(default_factory=list)
    safe_attrs: set[str] = field(default_factory=set)


class _MethodScanner:
    def __init__(self, facts: _ClassFacts, method: str) -> None:
        self.facts = facts
        self.method = method

    def scan(self, node: ast.AST, *, in_lock: bool = False, in_loop: bool = False) -> None:
        for child in ast.iter_child_nodes(node):
            self._scan_node(child, in_lock=in_lock, in_loop=in_loop)

    def _scan_node(self, node: ast.AST, *, in_lock: bool, in_loop: bool) -> None:
        if isinstance(node, ast.ClassDef):
            return  # nested classes are analyzed on their own
        if isinstance(node, ast.With):
            holds = in_lock or any(
                self._is_lock_expr(item.context_expr) for item in node.items
            )
            for stmt in node.body:
                self._scan_node(stmt, in_lock=holds, in_loop=in_loop)
            return
        if isinstance(node, (ast.For, ast.While)):
            # the test/iter parts evaluate once per iteration too
            for child in ast.iter_child_nodes(node):
                self._scan_node(child, in_lock=in_lock, in_loop=True)
            return
        if isinstance(node, ast.Call):
            self._scan_call(node, in_lock=in_lock, in_loop=in_loop)
        self._record_mutation(node, in_lock)
        self.scan(node, in_lock=in_lock, in_loop=in_loop)

    @staticmethod
    def _is_lock_expr(expr: ast.expr) -> bool:
        attr = _self_rooted_base(expr)
        if attr is None and isinstance(expr, ast.Call):
            attr = _self_rooted_base(expr.func)
        return attr is not None and any(t in attr.lower() for t in _LOCKISH)

    def _scan_call(self, node: ast.Call, *, in_lock: bool, in_loop: bool) -> None:
        final = _dotted_final(node.func)
        if final == "Thread":
            self.facts.starts_threads = True
            for kw in node.keywords:
                if kw.arg == "target":
                    target = _self_attr(kw.value)
                    if target is not None:
                        prev = self.facts.targets.get(target, False)
                        self.facts.targets[target] = prev or in_loop
        # self-call graph edge
        callee = _self_attr(node.func)
        if callee is not None:
            self.facts.calls.setdefault(self.method, set()).add(callee)
        # in-place mutator on a self-rooted receiver
        if isinstance(node.func, ast.Attribute) and node.func.attr in _MUTATORS:
            base = _self_rooted_base(node.func.value)
            if base is not None:
                self._add(base, node.lineno, in_lock)

    def _record_mutation(self, node: ast.AST, in_lock: bool) -> None:
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = list(node.targets)
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                for el in t.elts:
                    self._record_target(el, node, in_lock)
            else:
                self._record_target(t, node, in_lock)

    def _record_target(self, t: ast.expr, node: ast.AST, in_lock: bool) -> None:
        attr = _self_rooted_base(t)
        if attr is not None:
            self._add(attr, getattr(node, "lineno", 0), in_lock)

    def _add(self, attr: str, lineno: int, in_lock: bool) -> None:
        self.facts.mutations.append(_Mutation(attr, self.method, lineno, in_lock))


def _collect_facts(cls: ast.ClassDef) -> _ClassFacts:
    facts = _ClassFacts(cls.name)
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if item.name == "__init__":
            for stmt in ast.walk(item):
                if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
                    ctor = _dotted_final(stmt.value.func)
                    if ctor in _THREAD_SAFE_TYPES:
                        for t in stmt.targets:
                            attr = _self_attr(t)
                            if attr is not None:
                                facts.safe_attrs.add(attr)
        _MethodScanner(facts, item.name).scan(item)
    return facts


def _reachable(facts: _ClassFacts) -> tuple[dict[str, set[str]], set[str]]:
    """-> (thread target -> methods reachable from it, multi-instance
    method set)."""
    per_target: dict[str, set[str]] = {}
    multi: set[str] = set()
    for target, in_loop in facts.targets.items():
        seen: set[str] = set()
        stack = [target]
        while stack:
            m = stack.pop()
            if m in seen:
                continue
            seen.add(m)
            stack.extend(facts.calls.get(m, ()))
        per_target[target] = seen
        if in_loop:
            multi |= seen
    return per_target, multi


class LockDisciplineRule(Rule):
    rule_id = "lock-discipline"
    description = (
        "engine classes that start threads must guard every mutation of a "
        "thread-shared self attribute with the same lock"
    )

    def check(self, ctx: RuleContext) -> list[Finding]:
        if "engine/" not in ctx.rel_path.replace("\\", "/"):
            return []
        findings: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(ctx, node))
        return findings

    def _check_class(self, ctx: RuleContext, cls: ast.ClassDef) -> list[Finding]:
        facts = _collect_facts(cls)
        if not facts.starts_threads:
            return []
        per_target, multi = _reachable(facts)
        thread_methods = set().union(*per_target.values()) if per_target else set()

        by_attr: dict[str, list[_Mutation]] = {}
        for m in facts.mutations:
            if m.attr in facts.safe_attrs:
                continue
            by_attr.setdefault(m.attr, []).append(m)

        findings: list[Finding] = []
        reported: set[tuple[str, int]] = set()

        def report(mut: _Mutation, why: str) -> None:
            key = (mut.attr, mut.lineno)
            if key in reported:
                return
            reported.add(key)
            findings.append(
                Finding(
                    ctx.rel_path, mut.lineno, self.rule_id,
                    f"self.{mut.attr} in {cls.name}.{mut.method} is mutated "
                    f"without holding the lock: {why}",
                )
            )

        for attr, muts in sorted(by_attr.items()):
            locked = [m for m in muts if m.in_lock]
            unguarded = [
                m for m in muts if not m.in_lock and m.method != "__init__"
            ]
            if not unguarded:
                continue
            # heuristic 1: inconsistently guarded
            if locked:
                lines = ", ".join(str(m.lineno) for m in locked[:4])
                for m in unguarded:
                    report(
                        m,
                        f"the same attribute is guarded elsewhere (line(s) "
                        f"{lines}); hold the lock here too",
                    )
                continue
            # heuristic 2: unguarded cross-thread mutation
            thread_muts = [m for m in unguarded if m.method in thread_methods]
            main_muts = [
                m
                for m in muts
                if m.method not in thread_methods and m.method != "__init__"
            ]
            if not thread_muts:
                continue
            touched_targets = {
                t for t, reach in per_target.items()
                if any(m.method in reach for m in thread_muts)
            }
            cross_thread = bool(main_muts) or len(touched_targets) > 1
            self_concurrent = any(m.method in multi for m in thread_muts)
            if cross_thread or self_concurrent:
                why = (
                    "the method runs on multiple threads at once"
                    if self_concurrent and not cross_thread
                    else "the attribute is also mutated from another thread context"
                )
                for m in thread_muts:
                    report(m, why)
                for m in main_muts:
                    if not m.in_lock:
                        report(m, "the attribute is also mutated from a worker thread")
        return findings
