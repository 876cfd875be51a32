"""Pipeline-graph linter: semantic validation of a ``PipelineSpec`` (port
of ``cosmos_curate_tpu/analysis/graph_lint.py``).

A mis-wired pipeline (mismatched stage task types, a GPU claim the
declared host cannot meet, a duplicate stage name) is rejected before a
single worker starts. ``run_pipeline`` calls :func:`validate_pipeline_spec` as an
on-by-default pre-flight (``skip_validation=True`` bypasses it).

Checks:

- **type-flow**: via ``typing.get_type_hints`` on each stage's
  ``process_data``: every task type stage *k* emits must be accepted by
  stage *k+1* (and the input tasks by stage 0). Untyped stages are
  skipped, not failed.
- **duplicate-stage**: two stages sharing a name would merge their
  metrics and stage counts (a warning).
- **infeasible-stage**: a stage whose GPU claim exceeds the declared host
  (``PipelineConfig.num_gpus``); checked only when the host is declared.
  The port's pipelined runner shares the host's cards between its stages,
  so claims are not summed.
- **nonsense-spec**: ``gpus > 0`` with ``entire_gpu_host``, and fewer than
  one run attempt.

Not ported: the reference's mesh-divisibility check of a stage's declared
device mesh, which waits for ``Stage.mesh_spec`` (ROADMAP queue A item 7);
and its summed STREAMING device and CPU budget checks: the port's runners
(the pipelined runner and the streaming engine, whose device stages are
threads of the driver) share the host's cards between device stages in
either execution mode, so their claims are not summed.
"""

from __future__ import annotations

import math
import types
import typing
from typing import TYPE_CHECKING, Any

from cosmos_curate_tpu_torch.analysis.common import Finding, Severity
from cosmos_curate_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:
    from cosmos_curate_tpu_torch.core.pipeline import PipelineSpec

logger = get_logger(__name__)

_SPEC_FILE = "<pipeline-spec>"


class PipelineValidationError(ValueError):
    """Raised by the ``run_pipeline`` pre-flight; carries all findings so a
    mis-wired spec surfaces every problem at once."""

    def __init__(self, findings: list[Finding]) -> None:
        self.findings = findings
        lines = "\n".join(f"  - {f.render()}" for f in findings)
        super().__init__(
            f"pipeline spec failed pre-flight validation "
            f"({len(findings)} error(s); pass skip_validation=True to bypass):\n{lines}"
        )


# -- type-flow --------------------------------------------------------------


def _element_types(hint: Any) -> tuple[type, ...] | None:
    """``list[X]`` / ``list[X] | None`` / ``Optional[list[X | Y]]`` -> the
    element classes, or None when nothing checkable can be extracted
    (missing hint, TypeVar, Any, unparameterized list)."""
    if hint is None:
        return None
    origin = typing.get_origin(hint)
    if origin is typing.Union or origin is types.UnionType:
        for arm in typing.get_args(hint):
            if arm is type(None):
                continue
            got = _element_types(arm)
            if got is not None:
                return got
        return None
    if origin not in (list, typing.List):
        return None
    args = typing.get_args(hint)
    if not args:
        return None
    elems: list[type] = []
    for a in args:
        a_origin = typing.get_origin(a)
        if a_origin is typing.Union or a_origin is types.UnionType:
            members = [m for m in typing.get_args(a) if m is not type(None)]
        else:
            members = [a]
        for m in members:
            if not isinstance(m, type):  # TypeVar, Any, forward ref left over
                return None
            elems.append(m)
    return tuple(elems) or None


def _process_data_hints(stage: Any) -> tuple[tuple[type, ...] | None, tuple[type, ...] | None]:
    """-> (accepted element types, emitted element types) of a stage's
    ``process_data``, each None when unannotated or unresolvable."""
    fn = getattr(type(stage), "process_data", None)
    if fn is None:
        return None, None
    try:
        hints = typing.get_type_hints(fn)
    except Exception:  # unresolvable forward refs in user code: skip, don't fail
        return None, None
    params = [k for k in hints if k != "return"]
    accepts = _element_types(hints[params[0]]) if params else None
    emits = _element_types(hints.get("return"))
    return accepts, emits


def _compatible(emitted: tuple[type, ...], accepted: tuple[type, ...]) -> bool:
    return all(any(issubclass(e, a) for a in accepted) for e in emitted)


def _names(types_: tuple[type, ...]) -> str:
    return " | ".join(t.__name__ for t in types_)


def _check_type_flow(spec: PipelineSpec, findings: list[Finding]) -> None:
    stages = spec.stages
    flows = [(s.name, *_process_data_hints(s.stage)) for s in stages]
    # input tasks -> first stage
    if stages and spec.input_data:
        accepts = flows[0][1]
        if accepts is not None:
            bad = {type(t) for t in spec.input_data if not isinstance(t, accepts)}
            for t in sorted(bad, key=lambda c: c.__name__):
                findings.append(
                    Finding(
                        _SPEC_FILE, 0, "type-flow",
                        f"input tasks of type {t.__name__} are not accepted by first "
                        f"stage '{flows[0][0]}' (accepts {_names(accepts)})",
                    )
                )
    # stage k -> stage k+1
    for (up_name, _, emits), (down_name, accepts, _) in zip(flows, flows[1:]):
        if emits is None or accepts is None:
            continue  # untyped end: nothing checkable
        if not _compatible(emits, accepts):
            findings.append(
                Finding(
                    _SPEC_FILE, 0, "type-flow",
                    f"stage '{up_name}' emits {_names(emits)} but the next stage "
                    f"'{down_name}' accepts {_names(accepts)}",
                )
            )


# -- names ------------------------------------------------------------------


def _check_duplicate_names(spec: PipelineSpec, findings: list[Finding]) -> None:
    seen: dict[str, int] = {}
    for idx, s in enumerate(spec.stages):
        if s.name in seen:
            findings.append(
                Finding(
                    _SPEC_FILE, 0, "duplicate-stage",
                    f"stage name '{s.name}' used by both stage {seen[s.name]} and "
                    f"stage {idx}; their metrics and stage counts will merge under one name",
                    severity=Severity.WARNING,
                )
            )
        else:
            seen[s.name] = idx


# -- resources --------------------------------------------------------------


def _check_resources(spec: PipelineSpec, findings: list[Finding]) -> None:
    gpus = spec.config.num_gpus
    for s in spec.stages:
        res = s.stage.resources
        if res.gpus > 0 and res.entire_gpu_host:
            findings.append(
                Finding(
                    _SPEC_FILE, 0, "nonsense-spec",
                    f"stage '{s.name}' requests both gpus={res.gpus} and "
                    "entire_gpu_host=True; an entire-host claim already owns every "
                    "local card: drop one of the two",
                )
            )
        if s.num_run_attempts < 1:
            findings.append(
                Finding(
                    _SPEC_FILE, 0, "nonsense-spec",
                    f"stage '{s.name}' has num_run_attempts={s.num_run_attempts}; "
                    "at least one attempt is required",
                )
            )
        # against a *declared* host only; an undeclared one is discovered at
        # run time (core/pipelined_runner.discover_gpus). Stages share the
        # host's cards, so each claim is checked alone, never summed.
        need = max(res.gpus, 1.0 if res.entire_gpu_host else 0.0)
        if gpus is not None and need > gpus:
            findings.append(
                Finding(
                    _SPEC_FILE, 0, "infeasible-stage",
                    f"stage '{s.name}' needs {_fmt(need)} GPU(s) but the declared host has {gpus}",
                )
            )


def _fmt(x: float) -> str:
    return str(int(x)) if float(x).is_integer() and not math.isinf(x) else f"{x:g}"


# -- entry points -----------------------------------------------------------


def lint_pipeline_spec(spec: PipelineSpec) -> list[Finding]:
    """All findings (errors and warnings) of a pipeline spec."""
    findings: list[Finding] = []
    _check_duplicate_names(spec, findings)
    _check_type_flow(spec, findings)
    _check_resources(spec, findings)
    return findings


def validate_pipeline_spec(spec: PipelineSpec) -> None:
    """The ``run_pipeline`` pre-flight: raise on errors, log warnings."""
    findings = lint_pipeline_spec(spec)
    errors = [f for f in findings if f.severity is Severity.ERROR]
    for f in findings:
        if f.severity is not Severity.ERROR:
            logger.warning("pipeline pre-flight: %s", f.render())
    if errors:
        raise PipelineValidationError(errors)
