"""thread-lifecycle: a thread that can outlive shutdown.

``threading.Thread(...)`` without ``daemon=True`` keeps the interpreter
alive at exit; a non-daemon background thread with no reachable ``.join()``
on a shutdown path leaks past every clean-shutdown contract the service
relies on (compaction, live-status, prep, and watchdog threads must all
stop when their owner stops).

A ``Thread(...)`` call passes when ANY of:

- ``daemon=True`` is passed to the constructor;
- the created thread is bound to a name (``t = Thread(...)`` or
  ``self._t = Thread(...)``) and that name's ``.daemon = True`` is set or
  ``.join(...)`` is called somewhere in the same file (a join anywhere is
  taken as the shutdown path — this is a lint, not a model checker);
- ``daemon=...`` is passed a non-literal expression (the caller is
  forwarding a policy decision; we trust it).

Everything else — an anonymous ``Thread(...).start()``, a named thread
that is never joined nor daemonized — is flagged. Suppress deliberate
leaks with ``# curate-lint: disable=thread-lifecycle`` and a reason.
"""

from __future__ import annotations

import ast

from cosmos_curate_tpu_torch.analysis.common import Finding
from cosmos_curate_tpu_torch.analysis.rules import Rule, RuleContext


def _binding_name(parents: dict[ast.AST, ast.AST], call: ast.Call) -> str | None:
    """The name a Thread(...) result is bound to: ``t`` / ``self._t`` for
    direct assignments, walking through trivial wrappers is not attempted."""
    node: ast.AST = call
    parent = parents.get(node)
    while parent is not None and isinstance(parent, (ast.Await,)):
        node = parent
        parent = parents.get(node)
    if isinstance(parent, ast.Assign):
        for t in parent.targets:
            if isinstance(t, ast.Name):
                return t.id
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id in ("self", "cls")
            ):
                return t.attr
    if isinstance(parent, ast.AnnAssign):
        t = parent.target
        if isinstance(t, ast.Name):
            return t.id
        if (
            isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id in ("self", "cls")
        ):
            return t.attr
    return None


def _name_of(expr: ast.expr) -> str | None:
    if isinstance(expr, ast.Name):
        return expr.id
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id in ("self", "cls")
    ):
        return expr.attr
    return None


class ThreadLifecycleRule(Rule):
    rule_id = "thread-lifecycle"
    description = (
        "threading.Thread without daemon=True and without a .join() on any "
        "shutdown/close path — background threads must not outlive their owner"
    )

    def check(self, ctx: RuleContext) -> list[Finding]:
        tree = ctx.tree
        parents: dict[ast.AST, ast.AST] = {}
        joined: set[str] = set()
        daemonized: set[str] = set()
        thread_calls: list[ast.Call] = []
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
            if isinstance(node, ast.Call):
                func = node.func
                final = (
                    func.attr if isinstance(func, ast.Attribute)
                    else func.id if isinstance(func, ast.Name) else None
                )
                if final == "Thread":
                    thread_calls.append(node)
                elif final == "join" and isinstance(func, ast.Attribute):
                    name = _name_of(func.value)
                    if name is not None:
                        joined.add(name)
            elif isinstance(node, ast.Assign):
                # t.daemon = True / self._t.daemon = True
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and t.attr == "daemon"
                        and isinstance(node.value, ast.Constant)
                        and node.value.value is True
                    ):
                        name = _name_of(t.value)
                        if name is not None:
                            daemonized.add(name)

        findings: list[Finding] = []
        for call in thread_calls:
            verdict = self._check_thread(call, parents, joined, daemonized)
            if verdict is not None:
                findings.append(
                    Finding(ctx.rel_path, call.lineno, self.rule_id, verdict)
                )
        return findings

    def _check_thread(
        self,
        call: ast.Call,
        parents: dict[ast.AST, ast.AST],
        joined: set[str],
        daemonized: set[str],
    ) -> str | None:
        for kw in call.keywords:
            if kw.arg == "daemon":
                if isinstance(kw.value, ast.Constant):
                    if kw.value.value is True:
                        return None
                    # daemon=False is an explicit non-daemon: still needs a join
                    break
                return None  # forwarded expression: trust the caller
        name = _binding_name(parents, call)
        if name is None:
            return (
                "anonymous non-daemon Thread: it can neither be joined nor "
                "daemonized after start — pass daemon=True or bind and join it"
            )
        if name in joined or name in daemonized:
            return None
        return (
            f"thread '{name}' is neither daemon=True nor joined anywhere in "
            "this file: it outlives shutdown — join it on the close path or "
            "make it a daemon"
        )
