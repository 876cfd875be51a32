"""Shared vocabulary of the pipeline pre-flight: findings and severities
(port of the part of ``cosmos_curate_tpu/analysis/common.py`` that
``analysis/graph_lint.py`` uses)."""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"

    def __str__(self) -> str:
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
        """One NDJSON line (the machine interface)."""
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
