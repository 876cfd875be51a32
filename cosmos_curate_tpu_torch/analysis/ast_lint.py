"""AST-lint driver: run the rule set over files/directories (port of
``cosmos_curate_tpu/analysis/ast_lint.py``; it reads the same
``[tool.curate-lint]`` table of ``pyproject.toml``).

Entry points: :func:`run_lint` (library) and the
``cosmos-curate-tpu-torch lint`` subcommand (cli/lint_cli.py). Each
finding renders as ``file:line rule-id message``; the process exits nonzero
when anything survives suppression. Suppress with
``# curate-lint: disable=<rule>`` on (or directly above) the flagged line,
or ``# curate-lint: disable-file=<rule>`` anywhere in the file.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, Sequence

from cosmos_curate_tpu_torch.analysis.common import (
    Finding,
    LintConfig,
    find_pyproject,
    is_suppressed,
    load_config,
    parse_suppressions,
)
from cosmos_curate_tpu_torch.analysis.rules import Rule, RuleContext, all_rules


def iter_python_files(paths: Sequence[str | Path], exclude: Sequence[str]) -> list[Path]:
    """Expand targets to .py files. A target that does not exist (or is a
    non-Python file) raises: a typoed path must fail the gate loudly, not
    exit 0 as 'clean' having linted nothing."""
    out: list[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_file() and path.suffix == ".py":
            out.append(path)
        elif path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        elif path.is_file():
            raise ValueError(f"not a Python file: {path}")
        else:
            raise ValueError(f"no such file or directory: {path}")
    root = _repo_root()

    def excluded(f: Path) -> bool:
        rel = _rel(f, root)
        return any(pat and pat in rel for pat in exclude)

    return [f for f in out if not excluded(f)]


def _repo_root() -> Path:
    pyproject = find_pyproject()
    return pyproject.parent if pyproject else Path.cwd()


def _rel(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def lint_file(
    path: Path, config: LintConfig, rules: Iterable[Rule], root: Path | None = None
) -> list[Finding]:
    root = root or _repo_root()
    rel = _rel(path, root)
    try:
        source = path.read_text(encoding="utf-8")
    except (OSError, UnicodeDecodeError) as e:
        return [Finding(rel, 0, "io-error", f"cannot read file: {e}")]
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 0, "parse-error", f"syntax error: {e.msg}")]
    ctx = RuleContext(path=path, rel_path=rel, tree=tree, source=source, config=config)
    findings: list[Finding] = []
    for rule in rules:
        if config.rule_enabled(rule.rule_id):
            findings.extend(rule.check(ctx))
    per_line, file_wide = parse_suppressions(source)
    kept = [f for f in findings if not is_suppressed(f, per_line, file_wide)]
    kept.sort(key=lambda f: (f.line, f.rule))
    return kept


def run_lint(
    paths: Sequence[str | Path],
    config: LintConfig | None = None,
    rule_ids: Sequence[str] | None = None,
) -> list[Finding]:
    """Lint ``paths`` (files or directories); returns surviving findings.

    ``rule_ids`` narrows the run to specific rules (CLI ``--rules``),
    overriding the config's enable list.
    """
    config = config or load_config()
    rules = all_rules()
    if rule_ids:
        wanted = set(rule_ids)
        unknown = wanted - {r.rule_id for r in rules}
        if unknown:
            raise ValueError(f"unknown rule id(s): {', '.join(sorted(unknown))}")
        rules = [r for r in rules if r.rule_id in wanted]
        # an explicit --rules selection overrides the config's enable/disable
        config = LintConfig(
            enable=sorted(wanted),
            disable=[],
            exclude=config.exclude,
            python_floor=config.python_floor,
        )
    root = _repo_root()
    findings: list[Finding] = []
    for f in iter_python_files(paths, config.exclude):
        findings.extend(lint_file(f, config, rules, root))
    return findings
