"""Shared vocabulary of the port's analysis passes (port of
``cosmos_curate_tpu/analysis/common.py``): findings, severities,
suppression comments, and the ``[tool.curate-lint]`` config loaded from
``pyproject.toml``.

The config loader prefers ``tomllib`` and otherwise falls back to a
minimal parser that understands exactly the subset ``pyproject.toml`` uses
here (table headers, string values, flat string lists), as the
reference's does for its 3.10 floor.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field
from pathlib import Path


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


@dataclass(frozen=True)
class Finding:
    """One diagnostic, formatted as ``file:line rule-id message``."""

    file: str
    line: int
    rule: str
    message: str
    severity: Severity = Severity.ERROR

    def render(self) -> str:
        return f"{self.file}:{self.line} {self.rule} {self.message}"

    def to_json(self) -> str:
        """One NDJSON line (the ``lint --json`` machine interface, shared
        by every pillar — AST rules, graph, shardcheck, concurrency — so
        CI annotators never parse the human rendering)."""
        import json

        return json.dumps(
            {
                "rule": self.rule,
                "file": self.file,
                "line": self.line,
                "severity": self.severity.value,
                "message": self.message,
            },
            sort_keys=True,
        )


# -- suppression comments ---------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*curate-lint:\s*disable(?P<scope>-file)?=(?P<rules>[\w\-,* ]+)")


def parse_suppressions(source: str) -> tuple[dict[int, set[str]], set[str]]:
    """-> (line -> suppressed rule ids, file-wide suppressed rule ids).

    ``# curate-lint: disable=<rule>[,<rule>...]`` suppresses matching
    findings on its own line and, when the comment stands alone, on the
    next line (so a suppression can sit above the flagged statement).
    ``# curate-lint: disable-file=<rule>`` anywhere suppresses the rule for
    the whole file. ``all`` (or ``*``) matches every rule.
    """
    per_line: dict[int, set[str]] = {}
    file_wide: set[str] = set()
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        rules = {"all" if r == "*" else r for r in rules}
        if m.group("scope"):
            file_wide |= rules
            continue
        per_line.setdefault(lineno, set()).update(rules)
        if text[: m.start()].strip() == "":  # comment-only line: covers the next one
            per_line.setdefault(lineno + 1, set()).update(rules)
    return per_line, file_wide


def is_suppressed(
    finding: Finding, per_line: dict[int, set[str]], file_wide: set[str]
) -> bool:
    for rules in (file_wide, per_line.get(finding.line, set())):
        if "all" in rules or finding.rule in rules:
            return True
    return False


# -- configuration ----------------------------------------------------------


@dataclass
class LintConfig:
    enable: list[str] = field(default_factory=list)  # empty = all rules
    disable: list[str] = field(default_factory=list)
    exclude: list[str] = field(default_factory=list)
    # (major, minor) interpreter floor for the min-python rule.
    python_floor: tuple[int, int] = (3, 10)
    # shardcheck defaults (analysis/shard_check.py): the mesh extents the
    # pass resolves specs against ("data=2,seq=2"; unnamed axes = 1) and
    # the per-device HBM budget for the replicated-params estimate
    # (0 disables the budget warning).
    shard_mesh: str = ""
    shard_hbm_gb: float = 0.0

    def rule_enabled(self, rule_id: str) -> bool:
        if rule_id in self.disable:
            return False
        return not self.enable or rule_id in self.enable


_FLOOR_RE = re.compile(r">=\s*(\d+)\.(\d+)")


def _parse_floor(spec: str) -> tuple[int, int] | None:
    m = _FLOOR_RE.search(spec or "")
    if m:
        return int(m.group(1)), int(m.group(2))
    m = re.fullmatch(r"\s*(\d+)\.(\d+)\s*", spec or "")
    if m:
        return int(m.group(1)), int(m.group(2))
    return None


def _toml_tables(text: str) -> dict[str, dict[str, object]]:
    """Fallback TOML subset parser: ``[table]`` headers, ``key = value``
    with string / flat string-list / number / bool values. Enough for the
    two fields the linter reads; anything fancier should come through
    ``tomllib`` on 3.11+."""
    tables: dict[str, dict[str, object]] = {}
    current: dict[str, object] = tables.setdefault("", {})
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            name = line.strip("[]").strip().strip('"')
            current = tables.setdefault(name, {})
            continue
        m = re.match(r"([\w\-\.\"]+)\s*=\s*(.+)$", line)
        if not m:
            continue
        key = m.group(1).strip('"')
        val = m.group(2).strip()
        # strip a trailing comment outside of quotes/brackets (best effort)
        if "#" in val and not val.startswith(("'", '"', "[")):
            val = val.split("#", 1)[0].strip()
        if val.startswith("[") and val.endswith("]"):
            items = re.findall(r"""["']([^"']*)["']""", val)
            current[key] = items
        elif val and val[0] in "\"'":
            current[key] = val[1:-1]
        elif val in ("true", "false"):
            current[key] = val == "true"
        else:
            try:
                current[key] = float(val) if "." in val else int(val)
            except ValueError:
                current[key] = val
    return tables


def _load_pyproject(path: Path) -> dict:
    text = path.read_text(encoding="utf-8")
    try:
        import tomllib  # py3.11+  # curate-lint: disable=min-python

        return tomllib.loads(text)
    except ImportError:
        tables = _toml_tables(text)
        return {
            "project": tables.get("project", {}),
            "tool": {"curate-lint": tables.get("tool.curate-lint", {})},
        }


def find_pyproject(start: Path | None = None) -> Path | None:
    here = (start or Path(__file__)).resolve()
    for parent in [here] + list(here.parents):
        cand = parent / "pyproject.toml"
        if cand.is_file():
            return cand
    return None


def load_config(pyproject: Path | None = None) -> LintConfig:
    """Build a ``LintConfig`` from ``[tool.curate-lint]`` + the
    ``project.requires-python`` floor; missing file/section -> defaults."""
    cfg = LintConfig()
    path = pyproject or find_pyproject()
    if path is None or not path.is_file():
        return cfg
    try:
        data = _load_pyproject(path)
    except (OSError, ValueError):
        return cfg
    floor = _parse_floor(str(data.get("project", {}).get("requires-python", "")))
    if floor:
        cfg.python_floor = floor
    section = data.get("tool", {}).get("curate-lint", {})
    cfg.enable = [str(r) for r in section.get("enable", [])]
    cfg.disable = [str(r) for r in section.get("disable", [])]
    cfg.exclude = [str(p) for p in section.get("exclude", cfg.exclude)]
    override = _parse_floor(str(section.get("python-floor", "")))
    if override:
        cfg.python_floor = override
    cfg.shard_mesh = str(section.get("shard-mesh", cfg.shard_mesh))
    try:
        cfg.shard_hbm_gb = float(section.get("shard-hbm-gb", cfg.shard_hbm_gb))
    except (TypeError, ValueError):
        # leaving 0.0 would silently disable the budget check the user
        # explicitly configured — say why
        from cosmos_curate_tpu_torch.utils.logging import get_logger

        get_logger(__name__).warning(
            "[tool.curate-lint] shard-hbm-gb=%r is not a number; "
            "HBM-budget check disabled",
            section.get("shard-hbm-gb"),
        )
    return cfg
