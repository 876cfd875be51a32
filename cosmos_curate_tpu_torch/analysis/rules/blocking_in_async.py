"""blocking-in-async: synchronous blocking calls inside ``async def``.

An event loop runs every coroutine on one thread: a single ``os.fsync``
(milliseconds on a good day, seconds on a loaded disk) freezes EVERY
in-flight request, not just the one that made it. The service found this
the hard way — the dispatcher journaled job transitions with a
flush+fsync directly on the loop, so interactive-lane submissions paid
for batch-job journaling (service/app.py now offloads appends to a
single-thread executor).

The call table is shared with the concurrency verifier's
blocking-under-lock analysis (``analysis/concurrency_check.py``) — the
same calls that stall a lock's waiters stall an event loop:

- ``os.fsync``/``os.fdatasync``, ``time.sleep`` (use ``asyncio.sleep``),
  ``subprocess.run/Popen/...``, ``shutil.copy*/move``;
- socket ``accept``/``recv*``/``sendall`` (use loop transports or
  ``sock_*`` wrappers);
- blocking ``Queue.put``/``get`` on queue-ish receivers (``asyncio.Queue``
  is awaited, so its put/get never match the call shape flagged here);
- ``thread/proc/worker/agent``-ish ``.join()``;
- repo contract: ``*journal*.append(...)`` / ``.compact(...)`` — the
  JobJournal fsyncs before returning by durability contract, so calling
  it from a coroutine is an fsync on the loop in disguise.

Blocking rarely sits lexically in the coroutine — the service's fsync hid
two frames down (``async invoke`` → ``record_transition`` →
``journal.append``). So the rule is transitive within a file: it first
maps every SYNC function to the blocking calls reachable through
same-file calls, then flags an ``async def`` both for direct hits and for
calling a sync function whose closure blocks (the finding names the
chain).

Nested ``def``/``lambda`` bodies are skipped: the dominant idiom for
fixing a finding is wrapping the call for ``run_in_executor`` /
``asyncio.to_thread``, and the wrapper executes on an executor thread.
``await``-ed expressions are fine by construction (awaitables yield).
"""

from __future__ import annotations

import ast
import re

from cosmos_curate_tpu_torch.analysis.common import Finding
from cosmos_curate_tpu_torch.analysis.rules import Rule, RuleContext

_JOURNALISH = re.compile(r"journal", re.IGNORECASE)


def _receiver(func: ast.expr) -> str | None:
    """Best-effort receiver name of an attribute call: ``a.b.c()`` -> "b",
    ``x.get()`` -> "x" (matching concurrency_check's receiver heuristics)."""
    if not isinstance(func, ast.Attribute):
        return None
    v = func.value
    if isinstance(v, ast.Name):
        return v.id
    if isinstance(v, ast.Attribute):
        return v.attr
    return None


def _blocking_desc(node: ast.Call) -> str | None:
    """The shared blocking-call table, minus the lock-specific entries
    (cv.wait, jit dispatch) that need held-lock context to judge."""
    from cosmos_curate_tpu_torch.analysis.concurrency_check import (
        _QUEUEISH,
        _JOINABLE,
        _SOCKET_BLOCKERS,
        _SUBPROCESS_BLOCKERS,
    )

    func = node.func
    attr = func.attr if isinstance(func, ast.Attribute) else None
    recv = _receiver(func)
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        owner = func.value.id
        if owner == "os" and attr in ("fsync", "fdatasync"):
            return f"os.{attr}()"
        if owner == "time" and attr == "sleep":
            return "time.sleep() (use asyncio.sleep)"
        if owner == "subprocess" and attr in _SUBPROCESS_BLOCKERS:
            return f"subprocess.{attr}()"
        if owner == "shutil" and attr in ("copy", "copy2", "copytree", "move"):
            return f"shutil.{attr}()"
    if attr in _SOCKET_BLOCKERS:
        return f".{attr}() (socket)"
    if attr in ("put", "get") and recv and _QUEUEISH.search(recv):
        if not any(
            kw.arg == "block"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is False
            for kw in node.keywords
        ):
            return f"blocking {recv}.{attr}()"
    if attr == "join" and recv and _JOINABLE.search(recv):
        return f"{recv}.join()"
    if attr in ("append", "compact") and recv and _JOURNALISH.search(recv):
        # JobJournal.append flush+fsyncs before returning (durability
        # before ack); from a coroutine that is an fsync on the loop
        return f"{recv}.{attr}() (fsyncs by contract)"
    return None


def _local_callee(func: ast.expr) -> str | None:
    """Name of a same-file callee: ``self.foo(...)`` / ``obj.foo(...)`` /
    ``foo(...)`` -> "foo". Resolution is by bare name — methods of OTHER
    objects that happen to share a local function's name can false-match,
    which suppression comments cover (precision over a type checker we
    don't have)."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


class _BodyScanner(ast.NodeVisitor):
    """Collects blocking calls + local-callee names lexically inside ONE
    function, skipping nested function scopes and awaited expressions."""

    def __init__(self) -> None:
        self.hits: list[tuple[int, str]] = []
        self.calls: list[tuple[int, str]] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass  # nested sync def: its body runs wherever it is called

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass  # nested coroutine: flagged when visited as its own root

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass  # lambdas are the run_in_executor wrapper idiom

    def visit_Await(self, node: ast.Await) -> None:
        # the awaited call itself yields; its ARGUMENTS still evaluate
        # synchronously on the loop
        if isinstance(node.value, ast.Call):
            for arg in node.value.args:
                self.visit(arg)
            for kw in node.value.keywords:
                self.visit(kw.value)
        else:
            self.visit(node.value)

    def visit_Call(self, node: ast.Call) -> None:
        desc = _blocking_desc(node)
        if desc is not None:
            self.hits.append((node.lineno, desc))
        callee = _local_callee(node.func)
        if callee is not None:
            self.calls.append((node.lineno, callee))
        self.generic_visit(node)


def _scan(node: ast.FunctionDef | ast.AsyncFunctionDef) -> _BodyScanner:
    scanner = _BodyScanner()
    for stmt in node.body:
        scanner.visit(stmt)
    return scanner


def _sync_blocking_closure(
    tree: ast.Module,
) -> dict[str, str]:
    """sync function name -> description of the blocking call reachable
    from it through same-file sync calls (fixed-point over the call map)."""
    scans: dict[str, _BodyScanner] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            scans[node.name] = _scan(node)
    blocking: dict[str, str] = {
        name: s.hits[0][1] for name, s in scans.items() if s.hits
    }
    changed = True
    while changed:
        changed = False
        for name, s in scans.items():
            if name in blocking:
                continue
            for _lineno, callee in s.calls:
                if callee != name and callee in blocking:
                    blocking[name] = f"{callee}() → {blocking[callee]}"
                    changed = True
                    break
    return blocking


class BlockingInAsyncRule(Rule):
    rule_id = "blocking-in-async"
    description = (
        "synchronous blocking call (fsync/sleep/subprocess/socket/queue/"
        "join/journal-append) inside an async def: stalls every coroutine "
        "on the event loop"
    )

    def check(self, ctx: RuleContext) -> list[Finding]:
        rel = ctx.rel_path.replace("\\", "/")
        if rel.startswith("tests/"):
            return []
        has_async = any(
            isinstance(n, ast.AsyncFunctionDef) for n in ast.walk(ctx.tree)
        )
        if not has_async:
            return []
        sync_blocking = _sync_blocking_closure(ctx.tree)
        findings: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            scanner = _scan(node)
            hits = list(scanner.hits)
            direct_lines = {lineno for lineno, _ in hits}
            for lineno, callee in scanner.calls:
                if callee in sync_blocking and lineno not in direct_lines:
                    hits.append(
                        (lineno, f"{callee}() → {sync_blocking[callee]}")
                    )
            for lineno, desc in sorted(hits):
                findings.append(
                    Finding(
                        ctx.rel_path, lineno, self.rule_id,
                        f"{desc} inside `async def {node.name}` blocks the "
                        "event loop for every coroutine; offload with "
                        "loop.run_in_executor(...) or use the async "
                        "equivalent",
                    )
                )
        return findings
