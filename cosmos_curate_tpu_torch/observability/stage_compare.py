"""Golden-output comparison: a recursive diff of task trees with tolerances
(port of ``cosmos_curate_tpu/observability/stage_compare.py``).

``compare_tasks`` walks two task lists item by item (dataclass fields,
dicts, sequences, arrays, scalars) and reports every path that differs;
``CompareReport`` carries the pass rate against a threshold. Floats and
float arrays compare within ``atol``; everything else exactly.

One branch the reference does not need: a ``torch.Tensor`` compares as its
CPU numpy array, under the same shape and ``atol`` rules (without it a
tensor would fall through to ``vars()``). torch is never imported here: the
branch reads it from ``sys.modules``, since a tensor can only exist once
torch is loaded.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any

import numpy as np


@dataclass
class Mismatch:
    path: str
    reason: str


@dataclass
class CompareReport:
    total: int = 0
    passed: int = 0
    mismatches: list[Mismatch] = field(default_factory=list)

    @property
    def pass_rate(self) -> float:
        return self.passed / self.total if self.total else 1.0

    def ok(self, threshold: float = 1.0) -> bool:
        return self.pass_rate >= threshold

    def summary(self) -> str:
        lines = [f"compare: {self.passed}/{self.total} passed ({self.pass_rate:.1%})"]
        lines += [f"  {m.path}: {m.reason}" for m in self.mismatches[:20]]
        if len(self.mismatches) > 20:
            lines.append(f"  … {len(self.mismatches) - 20} more")
        return "\n".join(lines)


def _as_numpy(x: Any) -> Any:
    """A torch tensor as its CPU numpy array (bf16 widened to fp32, which
    numpy lacks); anything else unchanged."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(x, torch.Tensor):
        return x
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


def _diff(a: Any, b: Any, path: str, out: list[Mismatch], atol: float, ignore: set[str]) -> None:
    a, b = _as_numpy(a), _as_numpy(b)
    if type(a) is not type(b) and not (isinstance(a, (int, float)) and isinstance(b, (int, float))):
        out.append(Mismatch(path, f"type {type(a).__name__} != {type(b).__name__}"))
        return
    if isinstance(a, np.ndarray):
        if a.shape != b.shape:
            out.append(Mismatch(path, f"shape {a.shape} != {b.shape}"))
        elif a.dtype.kind in "fc" or b.dtype.kind in "fc":
            if not np.allclose(a, b, atol=atol, equal_nan=True):
                out.append(Mismatch(path, f"max |Δ| {np.abs(a - b).max():.3e} > atol {atol}"))
        elif not np.array_equal(a, b):
            out.append(Mismatch(path, "arrays differ"))
        return
    if isinstance(a, float):
        if abs(a - b) > atol and not (np.isnan(a) and np.isnan(b)):
            out.append(Mismatch(path, f"{a} != {b} (atol {atol})"))
        return
    if isinstance(a, (int, str, bytes, bool, type(None))):
        if a != b:
            out.append(Mismatch(path, f"{a!r} != {b!r}"))
        return
    if isinstance(a, dict):
        for k in sorted(set(a) | set(b), key=str):
            if str(k) in ignore:
                continue
            if k not in a or k not in b:
                out.append(Mismatch(f"{path}.{k}", "missing on one side"))
            else:
                _diff(a[k], b[k], f"{path}.{k}", out, atol, ignore)
        return
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            out.append(Mismatch(path, f"length {len(a)} != {len(b)}"))
            return
        for i, (x, y) in enumerate(zip(a, b)):
            _diff(x, y, f"{path}[{i}]", out, atol, ignore)
        return
    if is_dataclass(a):
        for f in fields(a):
            if f.name in ignore:
                continue
            _diff(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}", out, atol, ignore)
        return
    if hasattr(a, "__dict__"):
        _diff(vars(a), vars(b), path, out, atol, ignore)
        return
    if a != b:
        out.append(Mismatch(path, f"{a!r} != {b!r}"))


def compare_tasks(
    actual: list,
    golden: list,
    *,
    atol: float = 1e-5,
    ignore_fields: tuple[str, ...] = ("stage_perf",),
) -> CompareReport:
    """Compare two task lists item by item; an item passes when it gives
    no mismatch."""
    report = CompareReport()
    if len(actual) != len(golden):
        report.total = max(len(actual), len(golden))
        report.mismatches.append(Mismatch("$", f"task count {len(actual)} != {len(golden)}"))
        return report
    ignore = set(ignore_fields)
    for i, (a, g) in enumerate(zip(actual, golden)):
        found: list[Mismatch] = []
        _diff(a, g, f"task[{i}]", found, atol, ignore)
        report.total += 1
        if found:
            report.mismatches.extend(found)
        else:
            report.passed += 1
    return report
