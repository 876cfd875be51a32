"""silent-swallow: broad exception handlers that drop errors in worker loops.

A bare ``except:`` / ``except Exception:`` inside an engine worker loop
that neither re-raises, logs, nor performs any remediation turns a
systematic failure (every batch poisoned, a dead socket, a full disk) into
silent data loss at petabyte scale. Scoped to files under ``engine/`` and
to handlers lexically inside a ``for``/``while`` loop — the hot paths where
a swallowed exception repeats forever.

A handler counts as *silent* only when its body contains no ``raise``, no
log-like call (``logger.*``, ``logging.*``, ``print``, ``warnings.warn``,
``traceback.print_exc``) and no other call at all (so cleanup/remediation
handlers — ``proc.terminate()``, ``sock.close()`` — are not flagged).
"""

from __future__ import annotations

import ast

from cosmos_curate_tpu_torch.analysis.common import Finding
from cosmos_curate_tpu_torch.analysis.rules import Rule, RuleContext

_BROAD = {"Exception", "BaseException"}
_LOG_METHODS = {"debug", "info", "warning", "error", "exception", "critical", "log", "warn"}


def _is_broad(handler: ast.ExceptHandler) -> str | None:
    """-> the broad exception name, or None for narrow handlers."""
    t = handler.type
    if t is None:
        return "bare except"
    names = []
    if isinstance(t, ast.Tuple):
        names = [getattr(e, "id", getattr(e, "attr", "")) for e in t.elts]
    else:
        names = [getattr(t, "id", getattr(t, "attr", ""))]
    for n in names:
        if n in _BROAD:
            return f"except {n}"
    return None


def _is_silent(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return False
        if isinstance(node, ast.Call):
            return False  # any call = logging or remediation
        # `except Exception as e: err = e` propagates the error by hand
        # (e.g. raise-after-cleanup loops) — not a swallow
        if (
            handler.name
            and isinstance(node, ast.Name)
            and node.id == handler.name
            and isinstance(node.ctx, ast.Load)
        ):
            return False
    return True


class SilentSwallowRule(Rule):
    rule_id = "silent-swallow"
    description = (
        "bare/broad except with no re-raise, no log and no remediation "
        "inside engine worker loops"
    )

    def check(self, ctx: RuleContext) -> list[Finding]:
        if "engine/" not in ctx.rel_path.replace("\\", "/"):
            return []
        findings: list[Finding] = []
        self._walk(ctx, ctx.tree, in_loop=False, findings=findings)
        return findings

    def _walk(
        self, ctx: RuleContext, node: ast.AST, *, in_loop: bool, findings: list[Finding]
    ) -> None:
        for child in ast.iter_child_nodes(node):
            child_in_loop = in_loop or isinstance(child, (ast.For, ast.While))
            if isinstance(child, ast.ExceptHandler) and in_loop:
                broad = _is_broad(child)
                if broad and _is_silent(child):
                    findings.append(
                        Finding(
                            ctx.rel_path, child.lineno, self.rule_id,
                            f"{broad} inside a worker loop swallows errors "
                            "silently: re-raise, log, or narrow the exception "
                            "type",
                        )
                    )
            # function boundaries reset loop context: a handler inside a
            # nested function is only "in a loop" via its own loops
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                self._walk(ctx, child, in_loop=False, findings=findings)
            else:
                self._walk(ctx, child, in_loop=child_in_loop, findings=findings)
        return
