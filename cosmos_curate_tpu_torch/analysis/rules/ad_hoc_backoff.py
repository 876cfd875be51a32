"""ad-hoc-backoff: hand-rolled exponential-backoff sleeps.

The repo once carried four copies of ``time.sleep(min(2.0**attempt * 0.2,
5.0))`` — all without jitter, so a fleet of workers that saw the same
outage retried in lockstep and re-created the thundering herd on every
backoff step. The canonical helper (``storage/retry.py:sleep_backoff``)
adds full jitter and one shared schedule; this rule keeps new copies from
creeping back in.

Flags any ``time.sleep(expr)`` / bare ``sleep(expr)`` call whose argument
contains an exponentiation (``2 ** attempt``) — the signature of a
hand-rolled schedule — in every file except ``storage/retry.py`` itself.
"""

from __future__ import annotations

import ast

from cosmos_curate_tpu_torch.analysis.common import Finding
from cosmos_curate_tpu_torch.analysis.rules import Rule, RuleContext


def _is_sleep_call(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "sleep":
        # time.sleep / <anything>.sleep — Event.wait-style APIs don't
        # collide because their attr is not "sleep"
        return isinstance(f.value, ast.Name) and f.value.id == "time"
    return isinstance(f, ast.Name) and f.id == "sleep"


def _has_pow(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.BinOp) and isinstance(n.op, ast.Pow) for n in ast.walk(node)
    )


class AdHocBackoffRule(Rule):
    rule_id = "ad-hoc-backoff"
    description = (
        "hand-rolled exponential-backoff sleep outside storage/retry.py "
        "(no jitter: a worker fleet retries in lockstep)"
    )

    def check(self, ctx: RuleContext) -> list[Finding]:
        rel = ctx.rel_path.replace("\\", "/")
        if rel.endswith("storage/retry.py") or rel.startswith("tests/"):
            return []
        findings: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and _is_sleep_call(node)):
                continue
            if any(_has_pow(a) for a in node.args):
                findings.append(
                    Finding(
                        ctx.rel_path, node.lineno, self.rule_id,
                        "hand-rolled exponential backoff retries in lockstep "
                        "across a fleet; use "
                        "cosmos_curate_tpu_torch.storage.retry.sleep_backoff "
                        "(full jitter, shared schedule)",
                    )
                )
        return findings
