"""sync-readback: blocking host readback directly on a model forward (port
of ``cosmos_curate_tpu/analysis/rules/sync_readback.py``, aimed at the
torch idiom that carries the same hazard).

``model(x).cpu().numpy()``, ``np.asarray(model(x))`` or ``model(x).item()``
in model or stage code blocks the host until the card finishes the forward
AND the D2H copy completes, before it can even start preparing the next
batch: the overlap the async device pipeline (models/device_pipeline.py)
exists for is lost.

Scope: ``cosmos_curate_tpu_torch/models/`` and ``pipelines/*/stages/``:
the code that drives devices. ``models/device_pipeline.py`` itself is
exempt: its drain IS the one sanctioned readback point.

Detection is name-based, not type-based: a call counts as a forward when
the file binds its callee (directly or via ``self.``) from

- a ``torch.compile(...)`` or ``torch.cuda.make_graphed_callables(...)``
  call, or
- a call to a same-file function whose body contains one (the factory
  idiom), or
- it matches the forward-holder naming convention (``forward``,
  ``_forward*``, ``_apply``, ``_sample``, ``_compiled*``, ``model`` /
  ``_model``).

Flagged: ``np.asarray(<forward>(...))`` (and ``np.array`` ...), and
``.numpy()`` / ``.item()`` / ``.tolist()`` taken on a forward through
``.detach()`` / ``.float()`` / ``.cpu()`` / ``.to(...)``. A readback of a
plain variable is not flagged (the dispatch already happened; the rule
targets the call-and-block-inline idiom).
"""

from __future__ import annotations

import ast
import re

from cosmos_curate_tpu_torch.analysis.common import Finding
from cosmos_curate_tpu_torch.analysis.rules import Rule, RuleContext

_NUMPY_CONVERTERS = {"asarray", "array", "ascontiguousarray", "asanyarray"}
_READBACK_METHODS = {"numpy", "item", "tolist"}
# methods a readback chain passes through on its way to the host
_PASS_THROUGH = {"detach", "float", "half", "cpu", "to", "contiguous"}
_JIT_HOLDER_CONVENTION = re.compile(r"^(forward|_forward\w*|_apply|_sample|_compiled\w*|model|_model)$")
_COMPILERS = {"compile", "make_graphed_callables"}
_EXEMPT = ("models/device_pipeline.py",)


def _in_scope(rel: str) -> bool:
    rel = rel.replace("\\", "/")
    if any(rel.endswith(e) for e in _EXEMPT):
        return False
    if "cosmos_curate_tpu_torch/models/" in rel or rel.startswith("models/"):
        return True
    return "/stages/" in rel and "pipelines/" in rel


def _numpy_aliases(tree: ast.Module) -> set[str]:
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    names.add(a.asname or "numpy")
    return names or {"np", "numpy"}


def _contains_compile(node: ast.AST) -> bool:
    """Whether ``node`` calls a compiler of forwards (``torch.compile``,
    ``torch.cuda.make_graphed_callables``)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr in _COMPILERS:
                return True
            if isinstance(f, ast.Name) and f.id == "make_graphed_callables":
                return True
    return False


def _collect_jit_names(tree: ast.Module) -> set[str]:
    """Names (bare or ``self.<attr>`` attrs) bound from forward-compiling
    expressions, including through same-file factories (the concurrency
    pass reads them for its dispatch-under-lock check)."""
    factories: set[str] = {
        node.name
        for node in ast.walk(tree)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        and _contains_compile(node)
    }

    def value_is_jitty(value: ast.expr) -> bool:
        if _contains_compile(value):
            return True
        for n in ast.walk(value):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Name)
                and n.func.id in factories
            ):
                return True
        return False

    names: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if value is None or not value_is_jitty(value):
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                names.add(t.id)
            elif isinstance(t, ast.Attribute):
                names.add(t.attr)
    return names


def _callee_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _strip_pass_through(expr: ast.expr) -> ast.expr:
    """``f(x).detach().float().cpu()`` -> ``f(x)``."""
    while (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr in _PASS_THROUGH
    ):
        expr = expr.func.value
    return expr


class SyncReadbackRule(Rule):
    rule_id = "sync-readback"
    description = (
        ".cpu().numpy() / np.asarray / .item() blocking directly on a model "
        "forward in model/stage code: dispatch through "
        "models/device_pipeline.py (submit + deferred drain) instead"
    )

    def check(self, ctx: RuleContext) -> list[Finding]:
        if not _in_scope(ctx.rel_path):
            return []
        np_names = _numpy_aliases(ctx.tree)
        jit_names = _collect_jit_names(ctx.tree)

        def is_forward(expr: ast.expr) -> bool:
            expr = _strip_pass_through(expr)
            if not isinstance(expr, ast.Call):
                return False
            name = _callee_name(expr)
            if name is None:
                return False
            return name in jit_names or bool(_JIT_HOLDER_CONVENTION.match(name))

        findings: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
                continue
            f = node.func
            flagged = None
            if isinstance(f.value, ast.Name) and f.value.id in np_names and f.attr in _NUMPY_CONVERTERS:
                if node.args and is_forward(node.args[0]):
                    flagged = f"{f.value.id}.{f.attr}(<forward>)"
            elif f.attr in _READBACK_METHODS and is_forward(f.value):
                flagged = f"<forward>.{f.attr}()"
            if flagged:
                findings.append(
                    Finding(
                        ctx.rel_path, node.lineno, self.rule_id,
                        f"{flagged} blocks the host on device compute + D2H "
                        "inline; submit through DevicePipeline and drain "
                        "(models/device_pipeline.py) so transfer, compute, "
                        "and readback overlap",
                    )
                )
        return findings
