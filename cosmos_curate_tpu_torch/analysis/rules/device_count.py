"""hardcoded-device-count: global device discovery baked into shapes
(port of ``cosmos_curate_tpu/analysis/rules/device_count.py``, aimed at
the torch idiom that carries the same hazard).

Code that derives tensor shapes or a process layout from
``torch.cuda.device_count()``, or from the length or a slice of a device
list built from it, silently changes meaning with the host it happens to
run on: a batch sized on a one-card machine is wrong on an eight-card one,
and a sliced device list ignores the layout the rest of the pipeline
agreed on. Device counts belong in ONE place: ``parallel/`` (the mesh
layer, ROADMAP queue A item 7) and the cluster shape the pipeline
declares. Everything else should read extents off that layout.

Flagged outside ``parallel/``:

- ``torch.cuda.device_count()`` (also through ``from torch import cuda``
  or ``import torch.cuda as tc``);
- ``len(<device list>)``, where a device list is a list, comprehension or
  ``range`` whose source calls ``device_count()``;
- slicing such a device list (``devices[:n]`` inline).

One finding a site: a ``device_count()`` inside a flagged ``len`` or slice
is not flagged again. ``torch.cuda.get_device_name(0)`` (a constant-index
probe) and ``torch.cuda.is_available()`` stay clean.
"""

from __future__ import annotations

import ast

from cosmos_curate_tpu_torch.analysis.common import Finding
from cosmos_curate_tpu_torch.analysis.rules import Rule, RuleContext

_EXEMPT_PATH = "parallel/"


def _cuda_aliases(tree: ast.Module) -> tuple[set[str], set[str]]:
    """-> (names bound to the ``torch`` module, names bound to ``torch.cuda``)."""
    torch_names, cuda_names = {"torch"}, set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch":
                    torch_names.add(a.asname or "torch")
                elif a.name == "torch.cuda" and a.asname:
                    cuda_names.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name == "cuda":
                    cuda_names.add(a.asname or "cuda")
    return torch_names, cuda_names


def _is_device_count_call(node: ast.AST, torch_names: set[str], cuda_names: set[str]) -> bool:
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    if node.func.attr != "device_count":
        return False
    owner = node.func.value
    if isinstance(owner, ast.Name):
        return owner.id in cuda_names
    return (
        isinstance(owner, ast.Attribute)
        and owner.attr == "cuda"
        and isinstance(owner.value, ast.Name)
        and owner.value.id in torch_names
    )


def _is_device_list(node: ast.expr, torch_names: set[str], cuda_names: set[str]) -> bool:
    """A list, comprehension, ``list(...)`` or ``range(...)`` whose source
    calls ``device_count()``."""
    if not isinstance(node, (ast.List, ast.ListComp, ast.Call)):
        return False
    if isinstance(node, ast.Call) and not (
        isinstance(node.func, ast.Name) and node.func.id in ("list", "range", "tuple")
    ):
        return False
    return any(_is_device_count_call(n, torch_names, cuda_names) for n in ast.walk(node))


class HardcodedDeviceCountRule(Rule):
    rule_id = "hardcoded-device-count"
    description = (
        "device counts baked into shapes: torch.cuda.device_count(), or the "
        "length or a slice of a device list, outside parallel/"
    )

    def check(self, ctx: RuleContext) -> list[Finding]:
        if _EXEMPT_PATH in ctx.rel_path:
            return []
        torch_names, cuda_names = _cuda_aliases(ctx.tree)
        findings: list[Finding] = []
        covered: set[int] = set()

        def flag(node: ast.AST, what: str, fix: str) -> None:
            covered.update(id(n) for n in ast.walk(node))
            findings.append(
                Finding(
                    ctx.rel_path, node.lineno, self.rule_id,
                    f"{what}: {fix} (device counts belong to parallel/ and "
                    "the declared cluster shape, not call sites)",
                )
            )

        for node in ast.walk(ctx.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "len"
                and node.args
                and _is_device_list(node.args[0], torch_names, cuda_names)
            ):
                flag(node, "len(<device list>)", "read the extent off the declared layout")
            elif (
                isinstance(node, ast.Subscript)
                and isinstance(node.slice, ast.Slice)
                and _is_device_list(node.value, torch_names, cuda_names)
            ):
                flag(node, "slicing a device list", "take the devices the declared layout assigns")
        for node in ast.walk(ctx.tree):
            if id(node) not in covered and _is_device_count_call(node, torch_names, cuda_names):
                flag(node, "torch.cuda.device_count()", "read the extent off the declared layout")
        findings.sort(key=lambda f: f.line)
        return findings
