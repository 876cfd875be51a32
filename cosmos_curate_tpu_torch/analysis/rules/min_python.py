"""min-python: stdlib API newer than the project's interpreter floor.

The exact failure class that cost this repo 56 test files at collection:
``logging.getLevelNamesMapping()`` is 3.11-only, the runtime floor is 3.10,
and nothing flagged it until pytest hit the AttributeError. The floor comes
from ``project.requires-python`` in ``pyproject.toml`` (overridable via
``[tool.curate-lint] python-floor``), so declaring the floor once keeps the
code and the rule in lockstep.

Guarded usage is not flagged: imports inside ``try/except ImportError`` and
attribute uses inside an ``if hasattr(mod, "name")`` branch are exactly how
version-gated code should look.
"""

from __future__ import annotations

import ast

from cosmos_curate_tpu_torch.analysis.common import Finding
from cosmos_curate_tpu_torch.analysis.rules import Rule, RuleContext

# module.name -> first Python version providing it
_STDLIB_MIN: dict[str, tuple[int, int]] = {
    "logging.getLevelNamesMapping": (3, 11),
    "enum.StrEnum": (3, 11),
    "enum.ReprEnum": (3, 11),
    "enum.verify": (3, 11),
    "datetime.UTC": (3, 11),
    "asyncio.TaskGroup": (3, 11),
    "asyncio.timeout": (3, 11),
    "asyncio.timeout_at": (3, 11),
    "asyncio.Runner": (3, 11),
    "asyncio.Barrier": (3, 11),
    "contextlib.chdir": (3, 11),
    "hashlib.file_digest": (3, 11),
    "inspect.getmembers_static": (3, 11),
    "math.cbrt": (3, 11),
    "math.exp2": (3, 11),
    "operator.call": (3, 11),
    "typing.Self": (3, 11),
    "typing.Never": (3, 11),
    "typing.LiteralString": (3, 11),
    "typing.Required": (3, 11),
    "typing.NotRequired": (3, 11),
    "typing.assert_never": (3, 11),
    "typing.assert_type": (3, 11),
    "typing.reveal_type": (3, 11),
    "typing.dataclass_transform": (3, 11),
    "typing.override": (3, 12),
    "typing.TypeAliasType": (3, 12),
    "itertools.batched": (3, 12),
    "math.sumprod": (3, 12),
    "calendar.Month": (3, 12),
    "os.process_cpu_count": (3, 13),
    "copy.replace": (3, 13),
    "argparse.BooleanOptionalAction": (3, 9),  # kept for floors below 3.9
}

# whole modules introduced after 3.x
_STDLIB_MODULE_MIN: dict[str, tuple[int, int]] = {
    "tomllib": (3, 11),
    "wsgiref.types": (3, 11),
}


def _ver(v: tuple[int, int]) -> str:
    return f"{v[0]}.{v[1]}"


class MinPythonRule(Rule):
    rule_id = "min-python"
    description = (
        "flags stdlib APIs newer than the interpreter floor declared in "
        "pyproject.toml requires-python"
    )

    def check(self, ctx: RuleContext) -> list[Finding]:
        floor = ctx.config.python_floor
        findings: list[Finding] = []
        # module alias -> canonical module name, for `import logging as log`
        aliases: dict[str, str] = {}
        guarded_imports = _import_error_guarded_lines(ctx.tree)
        hasattr_guards = _hasattr_guarded(ctx.tree)

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = a.name.split(".")[0]
                    need = _STDLIB_MODULE_MIN.get(a.name)
                    if need and need > floor and node.lineno not in guarded_imports:
                        findings.append(
                            self._finding(ctx, node.lineno, f"module {a.name}", need, floor)
                        )
            elif isinstance(node, ast.ImportFrom):
                if node.module is None or node.level:
                    continue
                need_mod = _STDLIB_MODULE_MIN.get(node.module)
                if need_mod and need_mod > floor and node.lineno not in guarded_imports:
                    findings.append(
                        self._finding(ctx, node.lineno, f"module {node.module}", need_mod, floor)
                    )
                    continue
                for a in node.names:
                    key = f"{node.module}.{a.name}"
                    need = _STDLIB_MIN.get(key)
                    if need and need > floor and node.lineno not in guarded_imports:
                        findings.append(self._finding(ctx, node.lineno, key, need, floor))
            elif isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
                mod = aliases.get(node.value.id)
                if mod is None:
                    continue
                key = f"{mod}.{node.attr}"
                need = _STDLIB_MIN.get(key)
                if need and need > floor:
                    # guards are recorded under the receiver name as written
                    # (`hasattr(log, ...)` for `import logging as log`), so
                    # match on that, not the canonical module name
                    used = f"{node.value.id}.{node.attr}"
                    if used in hasattr_guards.get(node.lineno, set()):
                        continue
                    findings.append(self._finding(ctx, node.lineno, key, need, floor))
        return findings

    def _finding(
        self, ctx: RuleContext, lineno: int, what: str,
        need: tuple[int, int], floor: tuple[int, int],
    ) -> Finding:
        return Finding(
            ctx.rel_path, lineno, self.rule_id,
            f"{what} requires Python {_ver(need)}+ but the project floor is "
            f"{_ver(floor)} (pyproject.toml requires-python); use a "
            "version-gated fallback or raise the floor",
        )


def _import_error_guarded_lines(tree: ast.Module) -> set[int]:
    """Line numbers of import statements inside try blocks whose handlers
    catch ImportError/ModuleNotFoundError/Exception."""
    lines: set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        catches = False
        for h in node.handlers:
            names = []
            if h.type is None:
                catches = True
            elif isinstance(h.type, ast.Tuple):
                names = [getattr(e, "id", getattr(e, "attr", "")) for e in h.type.elts]
            else:
                names = [getattr(h.type, "id", getattr(h.type, "attr", ""))]
            if {"ImportError", "ModuleNotFoundError", "Exception", "BaseException"} & set(names):
                catches = True
        if not catches:
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.Import, ast.ImportFrom)):
                    lines.add(sub.lineno)
    return lines


def _hasattr_guarded(tree: ast.Module) -> dict[int, set[str]]:
    """line -> {"mod.attr", ...} usable there because an enclosing ``if``
    tested ``hasattr(mod, "attr")``."""
    guarded: dict[int, set[str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.If):
            continue
        keys: set[str] = set()
        for call in ast.walk(node.test):
            if (
                isinstance(call, ast.Call)
                and isinstance(call.func, ast.Name)
                and call.func.id == "hasattr"
                and len(call.args) == 2
                and isinstance(call.args[0], ast.Name)
                and isinstance(call.args[1], ast.Constant)
            ):
                keys.add(f"{call.args[0].id}.{call.args[1].value}")
        if not keys:
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                lineno = getattr(sub, "lineno", None)
                if lineno is not None:
                    guarded.setdefault(lineno, set()).update(keys)
    return guarded
