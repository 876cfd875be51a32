"""Rule registry for the port's AST linter (port of
``cosmos_curate_tpu/analysis/rules/__init__.py``).

A rule is an object with a ``rule_id``, a one-line ``description`` and a
``check(ctx: RuleContext) -> list[Finding]`` method. Rules are registered
explicitly here (no import-time magic): adding a rule means adding a module
under ``analysis/rules/`` and listing it in :func:`all_rules`.

The reference's two mesh rules (``mesh-axis-literal``,
``sharding-constraint-outside-jit``) read JAX's mesh and sharding API and
wait for the port's mesh layer (ROADMAP queue A item 7), with
``shard_check.py``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path

from cosmos_curate_tpu_torch.analysis.common import Finding, LintConfig


@dataclass
class RuleContext:
    """Everything a rule may look at for one file."""

    path: Path  # absolute path on disk
    rel_path: str  # repo-relative, POSIX-style; used in findings and scoping
    tree: ast.Module
    source: str
    config: LintConfig


class Rule:
    rule_id: str = ""
    description: str = ""

    def check(self, ctx: RuleContext) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


def all_rules() -> list[Rule]:
    from cosmos_curate_tpu_torch.analysis.rules.ad_hoc_backoff import AdHocBackoffRule
    from cosmos_curate_tpu_torch.analysis.rules.blocking_in_async import BlockingInAsyncRule
    from cosmos_curate_tpu_torch.analysis.rules.device_count import HardcodedDeviceCountRule
    from cosmos_curate_tpu_torch.analysis.rules.jit_transfer import JitTransferRule
    from cosmos_curate_tpu_torch.analysis.rules.lock_discipline import LockDisciplineRule
    from cosmos_curate_tpu_torch.analysis.rules.min_python import MinPythonRule
    from cosmos_curate_tpu_torch.analysis.rules.silent_swallow import SilentSwallowRule
    from cosmos_curate_tpu_torch.analysis.rules.sync_readback import SyncReadbackRule
    from cosmos_curate_tpu_torch.analysis.rules.thread_lifecycle import ThreadLifecycleRule

    return [
        LockDisciplineRule(),
        ThreadLifecycleRule(),
        BlockingInAsyncRule(),
        MinPythonRule(),
        JitTransferRule(),
        SilentSwallowRule(),
        AdHocBackoffRule(),
        HardcodedDeviceCountRule(),
        SyncReadbackRule(),
    ]
