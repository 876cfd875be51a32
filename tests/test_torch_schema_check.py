"""Port parity: the schema & wire-compat verifier
(``analysis/schema_check.py``) against the JAX package's.

- The port's golden copies under ``cosmos_curate_tpu_torch/analysis/schemas/``
  equal the reference's nine files byte for byte, and the port's pass,
  extracting each surface from the port's own engine, service, index,
  observability and utils, reports no drift against them; ``--update``
  regenerates the same bytes.
- Every surface the port extracts equals the reference's extraction: the
  durable formats and protocol frames the two packages share across a
  restart or across nodes. The bench row (``REFERENCE_OWNED``) has no
  writer in the port until its benchmark (ROADMAP A1): the port keeps its
  golden and registers no surface, version or shim for it.
- The seeded drifts of ``tests/analysis/test_schema_check.py`` classify
  the same in both packages (rule id, message, severity).
"""

from __future__ import annotations

import copy
import subprocess
import sys
from pathlib import Path

import pytest

from cosmos_curate_tpu.analysis import schema_check as jsc
from cosmos_curate_tpu_torch.analysis import schema_check as tsc
from cosmos_curate_tpu_torch.utils import schema_stamp as tstamp

REPO = Path(__file__).resolve().parents[1]
# the reference's surfaces that nothing in the port writes yet
REFERENCE_OWNED = {"bench-row"}


def test_goldens_are_the_references_byte_for_byte():
    names = sorted(p.name for p in jsc.GOLDEN_DIR.glob("*.json"))
    assert len(names) == 9
    assert sorted(p.name for p in tsc.GOLDEN_DIR.glob("*.json")) == names
    for name in names:
        assert (tsc.GOLDEN_DIR / name).read_bytes() == (jsc.GOLDEN_DIR / name).read_bytes(), name


def test_port_reports_no_drift():
    assert tsc.run_schema_check() == []
    assert [s.name for s in tsc.SURFACES] == [s.name for s in jsc.SURFACES if s.name not in REFERENCE_OWNED]
    assert all(s.file.startswith("cosmos_curate_tpu_torch/") for s in tsc.SURFACES)


@pytest.mark.parametrize("surface", [s.name for s in jsc.SURFACES])
def test_surface_extracts_as_the_reference(surface):
    if surface in REFERENCE_OWNED:
        assert surface not in {s.name for s in tsc.SURFACES} and surface not in tstamp.SCHEMA_VERSIONS
        assert (tsc.GOLDEN_DIR / f"{surface}.json").read_bytes() == (jsc.GOLDEN_DIR / f"{surface}.json").read_bytes()
        return
    tsurf = next(s for s in tsc.SURFACES if s.name == surface)
    jsurf = next(s for s in jsc.SURFACES if s.name == surface)
    assert (tsurf.kind, tsurf.file.replace("cosmos_curate_tpu_torch/", "cosmos_curate_tpu/")) == (jsurf.kind,
                                                                                                 jsurf.file)
    assert tsc.extract_surface(tsurf) == jsc.extract_surface(jsurf)


def test_update_regenerates_the_same_goldens(tmp_path, monkeypatch):
    monkeypatch.setattr(tsc, "GOLDEN_DIR", tmp_path)
    assert tsc.run_schema_check(update=True) == []
    assert sorted(p.stem for p in tmp_path.glob("*.json")) == sorted(s.name for s in tsc.SURFACES)
    for s in tsc.SURFACES:
        assert (tmp_path / f"{s.name}.json").read_bytes() == (jsc.GOLDEN_DIR / f"{s.name}.json").read_bytes(), s.name


def _surface(mod, kind="durable"):
    return mod.Surface("test-surface", kind, "some/file.py", lambda: 1, dict)


def _snap(version: int, fields: dict) -> dict:
    return {"surface": "test-surface", "kind": "durable", "version": version, "schemas": {"doc": {"fields": fields}}}


_F = {"required": True, "type": "str"}
_OPT = {"required": False, "type": "int"}
DRIFTS = {
    "identical": ("durable", _snap(1, {"a": _F}), _snap(1, {"a": _F}), None),
    "missing_golden": ("durable", None, _snap(1, {"a": _F}), None),
    "additive_no_bump": ("durable", _snap(1, {"a": _F}), _snap(1, {"a": _F, "b": _OPT}), None),
    "additive_bump": ("durable", _snap(1, {"a": _F}), _snap(2, {"a": _F, "b": _OPT}), None),
    "removal_no_bump": ("durable", _snap(1, {"a": _F, "b": _OPT}), _snap(1, {"a": _F}), None),
    "type_change_wire": ("wire", _snap(1, {"a": _F}), _snap(1, {"a": {**_F, "type": "int"}}), None),
    "required_flip": ("durable", _snap(1, {"a": _F}), _snap(1, {"a": {**_F, "required": False}}), None),
    "breaking_bump_no_shim": ("durable", _snap(1, {"a": _F, "b": _OPT}), _snap(3, {"a": _F}), False),
    "breaking_bump_shimmed": ("durable", _snap(1, {"a": _F, "b": _OPT}), _snap(2, {"a": _F}), True),
    "breaking_bump_wire": ("wire", _snap(1, {"a": _F, "b": _OPT}), _snap(2, {"a": _F}), False),
    "backwards": ("durable", _snap(2, {"a": _F}), _snap(1, {"a": _F}), None),
    "bump_no_change": ("durable", _snap(1, {"a": _F}), _snap(2, {"a": _F}), None),
}


@pytest.mark.parametrize("drift", sorted(DRIFTS))
def test_seeded_drift_classifies_as_the_reference(drift):
    kind, gold, cur, shim = DRIFTS[drift]
    kw = {} if shim is None else {"has_migration": lambda name, v: shim}
    got = tsc.classify_drift(_surface(tsc, kind), copy.deepcopy(gold), copy.deepcopy(cur), **kw)
    want = jsc.classify_drift(_surface(jsc, kind), copy.deepcopy(gold), copy.deepcopy(cur), **kw)
    assert [(f.file, f.line, f.rule, f.message, f.severity.value) for f in got] == [
        (f.file, f.line, f.rule, f.message, f.severity.value) for f in want]
    if drift != "identical":
        assert got


def test_stamp_versions_and_shims_cover_every_surface():
    for s in tsc.SURFACES:
        if s.kind == "durable":
            assert s.version() == tstamp.SCHEMA_VERSIONS[s.name]
    assert tstamp.has_migration("job-journal", 1) and not tstamp.has_migration("run-report", 1)
    want = __import__("cosmos_curate_tpu.utils.schema_stamp", fromlist=["x"]).describe()
    assert tstamp.describe() == {
        "versions": {k: v for k, v in want["versions"].items() if k not in REFERENCE_OWNED},
        "migrations": [m for m in want["migrations"] if m.split(":")[0] not in REFERENCE_OWNED],
    }


def test_schema_cli_matches_jax():
    for pkg in ("cosmos_curate_tpu", "cosmos_curate_tpu_torch"):
        out = subprocess.run([sys.executable, "-m", f"{pkg}.cli.main", "lint", "--schema", f"{pkg}/analysis"],
                             cwd=REPO, capture_output=True, text=True, timeout=300,
                             env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
        assert out.returncode == 0 and "clean" in out.stderr, (pkg, out.stderr)
