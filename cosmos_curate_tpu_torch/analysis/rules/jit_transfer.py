"""jit-transfer: host-device transfer smells inside compiled or captured
code (port of ``cosmos_curate_tpu/analysis/rules/jit_transfer.py``, aimed
at the torch idiom that carries the same hazard).

``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float(t)`` /
``int(t)`` and ``np.asarray`` inside a ``torch.compile``d function either
force a blocking device->host transfer per call or break the graph there;
inside a ``torch.cuda.graph`` capture they synchronize a stream that is
capturing, which fails the capture or bakes one value into the replayed
graph. Both are bugs you want at lint time, not on the card.

The rule inspects functions whose decorator list mentions ``compile``
(``@torch.compile``, ``@torch.compile(...)``, or wrapped in
``functools.partial``) and the bodies of ``with torch.cuda.graph(...)``
blocks, so plain eager code is never flagged.
"""

from __future__ import annotations

import ast

from cosmos_curate_tpu_torch.analysis.common import Finding
from cosmos_curate_tpu_torch.analysis.rules import Rule, RuleContext

_JIT_NAMES = {"compile"}
_TRANSFER_METHODS = {"item", "tolist", "cpu", "numpy", "__array__"}
_CAST_BUILTINS = {"float", "int", "bool", "complex"}
_NUMPY_CONVERTERS = {"asarray", "array", "ascontiguousarray", "asanyarray"}


def _mentions_jit(expr: ast.expr) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in _JIT_NAMES:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _JIT_NAMES:
            return True
    return False


def _numpy_aliases(tree: ast.Module) -> set[str]:
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in ("numpy", "numpy.ma"):
                    names.add(a.asname or "numpy")
    return names or {"np", "numpy", "onp"}


def _is_graph_capture(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(g):`` (or ``cuda.graph(g)``)."""
    expr = item.context_expr
    return (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr == "graph"
        and _dotted_tail(expr.func.value) == "cuda"
    )


def _own_nodes(fn: ast.AST):
    """The nodes of ``fn``'s body, not descending into nested functions
    (each is visited as a function of its own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _dotted_tail(node: ast.expr) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


class JitTransferRule(Rule):
    rule_id = "jit-transfer"
    description = (
        "host-device transfers (.item(), .tolist(), .cpu(), float()/int() on "
        "tensors, np.asarray) inside torch.compile'd functions or "
        "torch.cuda.graph captures"
    )

    def check(self, ctx: RuleContext) -> list[Finding]:
        findings: list[Finding] = []
        np_names = _numpy_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if any(_mentions_jit(d) for d in node.decorator_list):
                findings.extend(self._check_jit_body(ctx, node, node, np_names, "compiled function"))
                continue
            for inner in _own_nodes(node):
                if isinstance(inner, ast.With) and any(_is_graph_capture(i) for i in inner.items):
                    for stmt in inner.body:
                        findings.extend(self._check_jit_body(ctx, node, stmt, np_names, "CUDA graph capture in"))
        return findings

    def _check_jit_body(
        self,
        ctx: RuleContext,
        fn: ast.AST,
        body: ast.AST,
        np_names: set[str],
        where: str,
    ) -> list[Finding]:
        findings: list[Finding] = []
        fn_name = getattr(fn, "name", "<fn>")
        shape_names, traced_names = _classify_locals(fn)

        def flag(lineno: int, what: str, why: str) -> None:
            findings.append(
                Finding(
                    ctx.rel_path, lineno, self.rule_id,
                    f"{what} inside {where} '{fn_name}' {why}",
                )
            )

        for node in ast.walk(body):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute):
                if func.attr in _TRANSFER_METHODS and not isinstance(
                    func.value, ast.Name
                ):
                    flag(node.lineno, f".{func.attr}()",
                         "forces a blocking device->host transfer per call")
                elif func.attr in _TRANSFER_METHODS and isinstance(func.value, ast.Name):
                    # obj.item(): the type is unseen, but in compiled or
                    # captured code the receiver is almost always a tensor
                    flag(node.lineno, f"{func.value.id}.{func.attr}()",
                         "forces a blocking device->host transfer per call")
                elif (
                    isinstance(func.value, ast.Name)
                    and func.value.id in np_names
                    and func.attr in _NUMPY_CONVERTERS
                ):
                    flag(node.lineno, f"{func.value.id}.{func.attr}()",
                         "materializes the tensor on the host "
                         "(use torch equivalents)")
            elif isinstance(func, ast.Name) and func.id in _CAST_BUILTINS:
                if (
                    node.args
                    and not isinstance(node.args[0], ast.Constant)
                    and _references_traced(node.args[0], shape_names, traced_names)
                ):
                    flag(node.lineno, f"{func.id}()",
                         "concretizes a tensor (a graph break or a failed "
                         "capture, or a silent host sync)")
        return findings


def _is_shape_expr(expr: ast.expr) -> bool:
    """Shape arithmetic yields static Python ints under tracing:
    ``x.shape``, ``x.ndim``, ``len(x)`` — safe to cast."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in ("shape", "ndim", "size"):
            return True
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "len"
        ):
            return True
    return False


def _classify_locals(fn: ast.AST) -> tuple[set[str], set[str]]:
    """-> (names bound from shape-ish expressions, names that may hold
    tensors: parameters + every other local binding)."""
    shape_names: set[str] = set()
    traced: set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            traced.add(a.arg)
        if args.vararg:
            traced.add(args.vararg.arg)
        if args.kwarg:
            traced.add(args.kwarg.arg)
    for node in ast.walk(fn):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets, value = list(node.targets), node.value
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and node.value is not None:
            targets, value = [node.target], node.value
        elif isinstance(node, ast.For):
            targets, value = [node.target], node.iter
        else:
            continue
        bucket = shape_names if _is_shape_expr(value) else traced
        for t in targets:
            for el in t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]:
                if isinstance(el, ast.Name):
                    bucket.add(el.id)
    return shape_names - traced, traced


def _references_traced(expr: ast.expr, shape_names: set[str], traced: set[str]) -> bool:
    """True when the expression touches a name that may be a tensor.
    Names never bound locally (module constants) and shape-derived ints
    don't count, so ``int(h * _BAND)`` with ``h`` from ``x.shape`` is
    clean while ``int(loss)`` is flagged."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in traced and node.id not in shape_names:
            return True
    return False
