"""Schema & wire-compat verifier (``lint --schema``; port of
``cosmos_curate_tpu/analysis/schema_check.py``).

A driver and its agents, or a restarted service and its journal, are
routinely one build apart, and the port's durable formats are shared with
the reference's (a journal, a DLQ, an index written by either package reads
in the other). Every cross-process or cross-restart format is therefore a
**contract surface**, and this pass makes each one checkable:

Pass 1 - *extract*: build the current schema of every registered surface
straight from the port's code. Wire frames (``engine/remote_plane.py``
dataclasses) and ``JobRecord`` are introspected with
``dataclasses.fields``; JSON documents (journal envelope, DLQ meta, index
manifests, run_report, live status, node-stats) are extracted from the
writer's AST: dict literals are required fields, conditional
``doc["k"] = ...`` assignments are optional fields, dynamic keys become an
explicit ``<dynamic>`` marker; the object-channel GET tuple's arity and
element types come from its ``IfExp``. The reference's tenth surface, the
bench row (``bench-row``), has no writer in the port: its golden is kept
here byte for byte, and the port registers the surface when its benchmark
(ROADMAP queue A item 1) writes rows.

Pass 2 - *diff*: compare against the goldens under ``analysis/schemas/``
(copies of the reference's, byte for byte) and classify every drift:

- **additive** (new field/schema) without a version bump ->
  ``schema-additive-no-bump`` ERROR;
- **breaking** (removal, type change, required-flag change) without a
  bump -> ``schema-breaking-no-bump`` ERROR;
- breaking WITH a bump but no registered migration shim for a durable
  surface -> ``schema-missing-migration`` ERROR;
- any drift WITH a proper bump (and shim where required) ->
  ``schema-stale-golden`` WARNING: run ``lint --schema --update`` to
  re-snapshot the golden and commit both;
- version going BACKWARDS -> ``schema-version-backwards`` ERROR.

Versions come from the two enforcement points, never from this file:
``PROTOCOL_VERSION`` (``engine/remote_plane.py``) for wire surfaces, and
``utils/schema_stamp.SCHEMA_VERSIONS`` for durable ones.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Any, Callable

from cosmos_curate_tpu_torch.analysis.common import Finding, Severity

REPO_ROOT = Path(__file__).resolve().parents[2]
GOLDEN_DIR = Path(__file__).resolve().parent / "schemas"

# the explicit marker for computed keys (f-strings, variables): the golden
# records THAT dynamic keys exist, not what they expand to
DYNAMIC_KEY = "<dynamic>"


# -- schema model ------------------------------------------------------------
#
# A surface schema is plain JSON so goldens diff cleanly in review:
#   {"surface": ..., "kind": "wire"|"durable", "version": N,
#    "schemas": {name: {"fields": {field: {"type": str, "required": bool}}}}}


def _field(type_: str, required: bool) -> dict:
    return {"type": type_, "required": required}


def _infer_type(node: ast.AST | None) -> str:
    """Coarse, deterministic type label for a field's value expression.
    Deliberately conservative: anything not obviously typed is ``any`` so
    refactors that keep the shape do not churn goldens."""
    if node is None:
        return "any"
    if isinstance(node, ast.Constant):
        return type(node.value).__name__
    if isinstance(node, ast.Dict):
        return "dict"
    if isinstance(node, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(node, ast.Tuple):
        return "tuple"
    if isinstance(node, (ast.DictComp, ast.SetComp)):
        return "dict" if isinstance(node, ast.DictComp) else "set"
    if isinstance(node, ast.Compare) or (
        isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not)
    ):
        return "bool"
    if isinstance(node, ast.JoinedStr):
        return "str"
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else ""
        )
        return {
            "round": "float", "float": "float", "int": "int", "len": "int",
            "str": "str", "bool": "bool", "list": "list", "sorted": "list",
            "dict": "dict", "sum": "any", "min": "any", "max": "any",
        }.get(name, "any")
    return "any"


def _merge_field(fields: dict[str, dict], key: str, type_: str, required: bool) -> None:
    """Union of multiple writes to one key: required if ANY unconditional
    write exists; conflicting inferred types widen to ``any``."""
    prev = fields.get(key)
    if prev is None:
        fields[key] = _field(type_, required)
        return
    if prev["type"] != type_:
        fields[key] = _field("any", prev["required"] or required)
    else:
        prev["required"] = prev["required"] or required


# -- AST extraction of dict-shaped documents --------------------------------


def _find_function(tree: ast.Module, func: str, cls: str | None = None) -> ast.AST:
    scope: Any = tree
    if cls is not None:
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name == cls:
                scope = node
                break
        else:
            raise LookupError(f"class {cls} not found")
    for node in scope.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name == func:
            return node
    raise LookupError(f"function {func} not found" + (f" in class {cls}" if cls else ""))


def _dict_literal_fields(node: ast.Dict, fields: dict[str, dict], required: bool) -> None:
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            _merge_field(fields, k.value, _infer_type(v), required)
        elif k is None:
            # **splat: contents unknowable statically
            _merge_field(fields, DYNAMIC_KEY, "any", False)
        else:
            _merge_field(fields, DYNAMIC_KEY, _infer_type(v), False)


def _unwrap_stamp(node: ast.AST, fields: dict[str, dict], required: bool) -> ast.AST:
    """Unwrap ``json.dumps(...)`` and ``schema_stamp.stamp({...}, "s")``
    wrappers (recording the stamp field) so the inner dict literal is
    harvested — the journal writer's idiom is ``json.dumps(stamp({...}))``."""
    while isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.args:
        if node.func.attr == "stamp":
            _merge_field(fields, "schema_version", "int", required)
            node = node.args[0]
        elif node.func.attr == "dumps":
            node = node.args[0]
        else:
            break
    return node


def extract_dict_shape(
    path: Path, func: str, var: str, *, cls: str | None = None
) -> dict[str, dict]:
    """Schema of the dict built in variable ``var`` inside ``func``.

    Rules (the writer idioms this repo actually uses):
    - ``var = {...}`` / ``var.update({...})`` / ``return stamp({...})``
      outside any branch → required fields;
    - the same inside ``if``/``for``/``while``/``except`` → optional;
    - ``var["k"] = ...`` → required or optional by the same nesting test;
    - ``var.setdefault("k", v)`` → required (present after the call);
    - ``var[f"..."] = ...`` or non-constant keys → the ``<dynamic>``
      marker, so the golden records that computed keys exist;
    - ``schema_stamp.stamp(var, "surface")`` → ``schema_version`` field.
    """
    tree = ast.parse(path.read_text(encoding="utf-8"))
    fn = _find_function(tree, func, cls)
    fields: dict[str, dict] = {}

    def value_for(node: ast.AST, required: bool) -> None:
        node = _unwrap_stamp(node, fields, required)
        if isinstance(node, ast.Dict):
            _dict_literal_fields(node, fields, required)
        elif isinstance(node, ast.IfExp):
            # both arms contribute; keys not in both arms stay optional
            for arm in (node.body, node.orelse):
                value_for(arm, False)

    def visit(node: ast.AST, conditional: bool) -> None:
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            and node is not fn
        ):
            return  # nested defs are other scopes
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == var:
                    value_for(node.value, not conditional)
                elif (
                    isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == var
                ):
                    key = tgt.slice
                    if isinstance(key, ast.Constant) and isinstance(key.value, str):
                        _merge_field(
                            fields, key.value, _infer_type(node.value), not conditional
                        )
                    else:
                        _merge_field(fields, DYNAMIC_KEY, _infer_type(node.value), False)
        elif isinstance(node, ast.Return) and node.value is not None:
            value_for(node.value, not conditional)
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                if f.value.id == var and f.attr == "update" and node.args:
                    arg = node.args[0]
                    if isinstance(arg, ast.Dict):
                        _dict_literal_fields(arg, fields, not conditional)
                    else:
                        _merge_field(fields, DYNAMIC_KEY, "any", False)
                elif f.value.id == var and f.attr == "setdefault" and node.args:
                    key = node.args[0]
                    val = node.args[1] if len(node.args) > 1 else None
                    if isinstance(key, ast.Constant) and isinstance(key.value, str):
                        _merge_field(fields, key.value, _infer_type(val), not conditional)
                    else:
                        _merge_field(fields, DYNAMIC_KEY, _infer_type(val), False)
                elif f.attr == "stamp" and any(
                    isinstance(a, ast.Name) and a.id == var for a in node.args
                ):
                    _merge_field(fields, "schema_version", "int", not conditional)
        # branch/loop/handler bodies are conditional; `with` bodies are not
        # (they always execute)
        branch = conditional or isinstance(node, (ast.If, ast.For, ast.While, ast.Try))
        for child in ast.iter_child_nodes(node):
            visit(child, branch)

    for child in ast.iter_child_nodes(fn):
        visit(child, False)
    return {"fields": dict(sorted(fields.items()))}


def extract_stamped_literal(path: Path, func: str, *, cls: str | None = None) -> dict[str, dict]:
    """Schema of the FIRST ``schema_stamp.stamp({literal}, ...)`` call in
    ``func`` — for writers that stamp an inline document (e.g. the index
    MANIFEST.json pointer) rather than building a named variable."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    fn = _find_function(tree, func, cls)
    fields: dict[str, dict] = {}
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "stamp"
            and node.args
            and isinstance(node.args[0], ast.Dict)
        ):
            _merge_field(fields, "schema_version", "int", True)
            _dict_literal_fields(node.args[0], fields, True)
            break
    if not fields:
        raise LookupError(f"no stamp({{literal}}) call in {func}")
    return {"fields": dict(sorted(fields.items()))}


# -- dataclass + tuple extraction -------------------------------------------


def extract_dataclass(cls: type) -> dict[str, dict]:
    fields: dict[str, dict] = {}
    for f in dataclasses.fields(cls):
        required = (
            f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        )
        fields[f.name] = _field(str(f.type), required)
    return {"fields": dict(sorted(fields.items()))}


def extract_frames(module) -> dict[str, dict]:
    """Every frame in the module's ``WIRE_FRAMES`` registry (frames ride
    cloudpickle, so the class set + field set IS the wire schema). Falls
    back to every dataclass defined in the module when no registry exists."""
    frames = getattr(module, "WIRE_FRAMES", None)
    if frames is None:
        frames = [
            obj
            for _name, obj in sorted(vars(module).items())
            if isinstance(obj, type)
            and dataclasses.is_dataclass(obj)
            and obj.__module__ == module.__name__
        ]
    return {cls.__name__: extract_dataclass(cls) for cls in frames}


def extract_get_tuple(path: Path) -> dict[str, dict]:
    """The object-channel GET request: ``("get", name, nonce, tp) if tp
    else ("get", name, nonce)`` — positional fields, the 4th optional."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    fn = _find_function(tree, "_open_get")
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "req"
            and isinstance(node.value, ast.IfExp)
        ):
            arms = [node.value.body, node.value.orelse]
            if not all(isinstance(a, ast.Tuple) for a in arms):
                break
            long = max(arms, key=lambda t: len(t.elts))
            short = min(arms, key=lambda t: len(t.elts))
            fields: dict[str, dict] = {}
            for i, el in enumerate(long.elts):
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    type_ = f"str:{el.value}"  # the literal tag is contract
                elif isinstance(el, ast.Name) and el.id == "nonce":
                    type_ = "bytes"
                else:
                    type_ = "str"
                fields[str(i)] = _field(type_, i < len(short.elts))
            return {"get-request": {"fields": fields}}
    raise LookupError("object_channel._open_get request tuple not found")


# -- the registry ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Surface:
    """One contract surface: where its schema comes from and which version
    constant governs it."""

    name: str
    kind: str  # "wire" | "durable"
    file: str  # repo-relative, for findings
    version: Callable[[], int]
    extract: Callable[[], dict[str, dict]]  # schema name -> {"fields": ...}


def _protocol_version() -> int:
    from cosmos_curate_tpu_torch.engine import remote_plane

    return int(remote_plane.PROTOCOL_VERSION)


def _schema_version(surface: str) -> Callable[[], int]:
    def get() -> int:
        from cosmos_curate_tpu_torch.utils import schema_stamp

        return int(schema_stamp.SCHEMA_VERSIONS[surface])

    return get


def _x_remote_plane() -> dict[str, dict]:
    from cosmos_curate_tpu_torch.engine import remote_plane

    return extract_frames(remote_plane)


def _x_object_channel() -> dict[str, dict]:
    return extract_get_tuple(REPO_ROOT / "cosmos_curate_tpu_torch/engine/object_channel.py")


def _x_job_journal() -> dict[str, dict]:
    from cosmos_curate_tpu_torch.service.job_queue import JobRecord

    p = REPO_ROOT / "cosmos_curate_tpu_torch/service/job_queue.py"
    return {
        "envelope": extract_dict_shape(p, "append", "line", cls="JobJournal"),
        "JobRecord": extract_dataclass(JobRecord),
    }


def _x_dlq_meta() -> dict[str, dict]:
    p = REPO_ROOT / "cosmos_curate_tpu_torch/engine/dead_letter.py"
    return {"meta": extract_dict_shape(p, "record", "meta", cls="DeadLetterQueue")}


def _x_index_manifest() -> dict[str, dict]:
    p = REPO_ROOT / "cosmos_curate_tpu_torch/dedup/index_store.py"
    return {
        "manifest": extract_dict_shape(p, "build_live_manifest", "manifest", cls="IndexStore"),
        "pointer": extract_stamped_literal(p, "publish_manifest", cls="IndexStore"),
    }


def _x_run_report() -> dict[str, dict]:
    p = REPO_ROOT / "cosmos_curate_tpu_torch/observability/flight_recorder.py"
    return {"report": extract_dict_shape(p, "build_run_report", "report")}


def _x_node_stats() -> dict[str, dict]:
    p = REPO_ROOT / "cosmos_curate_tpu_torch/observability/flight_recorder.py"
    return {"stats": extract_dict_shape(p, "write_node_stats", "stats")}


def _x_live_status() -> dict[str, dict]:
    p = REPO_ROOT / "cosmos_curate_tpu_torch/observability/live_status.py"
    return {
        "status": extract_dict_shape(p, "publish", "snapshot", cls="LiveStatusPublisher")
    }


SURFACES: tuple[Surface, ...] = (
    Surface(
        "remote-plane", "wire", "cosmos_curate_tpu_torch/engine/remote_plane.py",
        _protocol_version, _x_remote_plane,
    ),
    Surface(
        "object-channel", "wire", "cosmos_curate_tpu_torch/engine/object_channel.py",
        _protocol_version, _x_object_channel,
    ),
    Surface(
        "job-journal", "durable", "cosmos_curate_tpu_torch/service/job_queue.py",
        _schema_version("job-journal"), _x_job_journal,
    ),
    Surface(
        "dlq-meta", "durable", "cosmos_curate_tpu_torch/engine/dead_letter.py",
        _schema_version("dlq-meta"), _x_dlq_meta,
    ),
    Surface(
        "index-manifest", "durable", "cosmos_curate_tpu_torch/dedup/index_store.py",
        _schema_version("index-manifest"), _x_index_manifest,
    ),
    Surface(
        "run-report", "durable", "cosmos_curate_tpu_torch/observability/flight_recorder.py",
        _schema_version("run-report"), _x_run_report,
    ),
    Surface(
        "node-stats", "durable", "cosmos_curate_tpu_torch/observability/flight_recorder.py",
        _schema_version("node-stats"), _x_node_stats,
    ),
    Surface(
        "live-status", "durable", "cosmos_curate_tpu_torch/observability/live_status.py",
        _schema_version("live-status"), _x_live_status,
    ),
)


def extract_surface(surface: Surface) -> dict:
    return {
        "surface": surface.name,
        "kind": surface.kind,
        "version": surface.version(),
        "schemas": surface.extract(),
    }


# -- diffing + drift classification -----------------------------------------


def _diff_schemas(gold: dict, cur: dict) -> tuple[list[str], list[str]]:
    """-> (additive drifts, breaking drifts) as human-readable deltas."""
    additive: list[str] = []
    breaking: list[str] = []
    gold_schemas, cur_schemas = gold.get("schemas", {}), cur.get("schemas", {})
    for name in sorted(set(gold_schemas) | set(cur_schemas)):
        if name not in cur_schemas:
            breaking.append(f"schema {name!r} removed")
            continue
        if name not in gold_schemas:
            additive.append(f"schema {name!r} added")
            continue
        gf = gold_schemas[name].get("fields", {})
        cf = cur_schemas[name].get("fields", {})
        for field_name in sorted(set(gf) | set(cf)):
            if field_name not in cf:
                breaking.append(f"{name}.{field_name} removed")
            elif field_name not in gf:
                additive.append(f"{name}.{field_name} added")
            else:
                g, c = gf[field_name], cf[field_name]
                if g["type"] != c["type"]:
                    breaking.append(
                        f"{name}.{field_name} type {g['type']} -> {c['type']}"
                    )
                if g["required"] != c["required"]:
                    breaking.append(
                        f"{name}.{field_name} "
                        f"{'required -> optional' if g['required'] else 'optional -> required'}"
                    )
    return additive, breaking


def classify_drift(
    surface: Surface,
    gold: dict | None,
    cur: dict,
    *,
    has_migration: Callable[[str, int], bool] | None = None,
) -> list[Finding]:
    """The drift rules (the reference's docs/STATIC_ANALYSIS.md, "drift classes"). Pure —
    the seeded-drift tests feed synthetic gold/cur pairs straight in."""
    if has_migration is None:
        from cosmos_curate_tpu_torch.utils import schema_stamp

        has_migration = schema_stamp.has_migration
    f = lambda rule, msg, sev=Severity.ERROR: Finding(  # noqa: E731
        surface.file, 1, rule, f"[{surface.name}] {msg}", sev
    )
    if gold is None:
        return [
            f(
                "schema-missing-golden",
                "no golden snapshot checked in; run `lint --schema --update` "
                "and commit analysis/schemas/",
            )
        ]
    gold_v, cur_v = int(gold.get("version", 1)), int(cur["version"])
    additive, breaking = _diff_schemas(gold, cur)
    if cur_v < gold_v:
        return [
            f(
                "schema-version-backwards",
                f"version went backwards: golden v{gold_v}, code v{cur_v} — "
                "published versions never decrease",
            )
        ]
    if not additive and not breaking:
        if cur_v > gold_v:
            return [
                f(
                    "schema-stale-golden",
                    f"version bumped v{gold_v} -> v{cur_v} with no schema change; "
                    "run `lint --schema --update` to re-snapshot the golden",
                    Severity.WARNING,
                )
            ]
        return []
    deltas = "; ".join(breaking + additive)
    if cur_v == gold_v:
        if breaking:
            return [
                f(
                    "schema-breaking-no-bump",
                    f"BREAKING drift without a version bump (still v{cur_v}): "
                    f"{deltas} — old peers/records would misread silently; bump "
                    + (
                        "PROTOCOL_VERSION in engine/remote_plane.py"
                        if surface.kind == "wire"
                        else f"SCHEMA_VERSIONS[{surface.name!r}] AND register a "
                        "migration shim in utils/schema_stamp.MIGRATIONS"
                    ),
                )
            ]
        return [
            f(
                "schema-additive-no-bump",
                f"additive drift without a version bump (still v{cur_v}): "
                f"{deltas} — old readers cannot tell they are missing fields; "
                + (
                    "bump PROTOCOL_VERSION in engine/remote_plane.py"
                    if surface.kind == "wire"
                    else f"bump SCHEMA_VERSIONS[{surface.name!r}] in utils/schema_stamp.py"
                ),
            )
        ]
    # version bumped: breaking drift on a durable surface additionally
    # needs a shim from every superseded version the bump skipped over
    if breaking and surface.kind == "durable":
        missing = [v for v in range(gold_v, cur_v) if not has_migration(surface.name, v)]
        if missing:
            return [
                f(
                    "schema-missing-migration",
                    f"breaking drift bumped v{gold_v} -> v{cur_v} ({deltas}) but "
                    f"no migration shim is registered for version(s) "
                    f"{', '.join(map(str, missing))} — version-N−1 records would "
                    "be unreadable; add ({0}, v) entries to "
                    "utils/schema_stamp.MIGRATIONS".format(surface.name),
                )
            ]
    return [
        f(
            "schema-stale-golden",
            f"drift acknowledged by bump v{gold_v} -> v{cur_v} ({deltas}); run "
            "`lint --schema --update` to re-snapshot the golden",
            Severity.WARNING,
        )
    ]


# -- entry points ------------------------------------------------------------


def golden_path(surface: Surface) -> Path:
    return GOLDEN_DIR / f"{surface.name}.json"


def load_golden(surface: Surface) -> dict | None:
    p = golden_path(surface)
    if not p.exists():
        return None
    return json.loads(p.read_text(encoding="utf-8"))


def run_schema_check(update: bool = False) -> list[Finding]:
    """``lint --schema`` (and ``--update``): extract every surface, diff
    against goldens, classify. ``update`` rewrites the goldens instead of
    reporting drift (extraction errors still report)."""
    findings: list[Finding] = []
    for surface in SURFACES:
        try:
            cur = extract_surface(surface)
        except Exception as e:  # extraction must never crash the gate
            findings.append(
                Finding(
                    surface.file, 1, "schema-extract-error",
                    f"[{surface.name}] schema extraction failed: {e}",
                )
            )
            continue
        if update:
            GOLDEN_DIR.mkdir(parents=True, exist_ok=True)
            golden_path(surface).write_text(
                json.dumps(cur, indent=1, sort_keys=True) + "\n", encoding="utf-8"
            )
            continue
        findings.extend(classify_drift(surface, load_golden(surface), cur))
    return findings


def describe() -> dict:
    """Machine-readable pillar summary (``--list-rules`` / tooling)."""
    from cosmos_curate_tpu_torch.utils import schema_stamp

    return {
        "surfaces": {
            s.name: {"kind": s.kind, "file": s.file, "version": s.version()}
            for s in SURFACES
        },
        **schema_stamp.describe(),
    }
