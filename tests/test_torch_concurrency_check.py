"""Port parity: the whole-repo concurrency verifier
(``analysis/concurrency_check.py``) against the JAX package's.

- Every fixture source of the reference's concurrency and rule tests
  (read out of ``tests/analysis/test_concurrency_check.py`` and the AST
  rule tests) through both passes, at a plain path and under ``engine/``
  (where the heuristic half of ``unguarded-shared`` yields to
  ``lock-discipline``): the same lock registry, the same acquisition-order
  edges and the same findings (rule id, line, message, severity).
- The port's caption engine keeps the canonical order ``_lock ->
  _prefix_lock -> _stats_lock`` with no suppression, as the reference's
  does, and the port's whole tree is concurrency-clean.
"""

from __future__ import annotations

from pathlib import Path

import pytest

from cosmos_curate_tpu.analysis import common as jcommon
from cosmos_curate_tpu.analysis import concurrency_check as jcc
from cosmos_curate_tpu_torch.analysis import common as tcommon
from cosmos_curate_tpu_torch.analysis import concurrency_check as tcc
from tests.test_torch_lint import fixture_sources

REPO = Path(__file__).resolve().parents[1]
FIXTURES = fixture_sources()


def _analysis(mod, common, root: Path, rel: str, code: str):
    f = root / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(code)
    a = mod.analyze([str(f)], common.LintConfig())
    findings = [(x.line, x.rule, x.message, x.severity.value) for x in a.findings]
    decls = sorted((d.key, d.line, d.ctor, d.reentrant, d.alias_of) for d in a.registry.decls.values())
    return findings, decls, sorted(a.edge_set())


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_concurrency_pass_matches_jax(fixture, tmp_path):
    for rel in ("mod.py", "engine/mod.py"):
        want = _analysis(jcc, jcommon, tmp_path, rel, FIXTURES[fixture])
        got = _analysis(tcc, tcommon, tmp_path, rel, FIXTURES[fixture])
        assert got == want, rel


def test_fixtures_exercise_every_rule(tmp_path):
    rules = set()
    for code in FIXTURES.values():
        rules |= {r for _, r, _, _ in _analysis(tcc, tcommon, tmp_path, "mod.py", code)[0]}
    assert {tcc.RULE_ORDER, tcc.RULE_BLOCKING, tcc.RULE_UNGUARDED} <= rules


def test_port_engine_keeps_the_canonical_lock_order():
    engine = REPO / "cosmos_curate_tpu_torch" / "models" / "vlm" / "engine.py"
    assert "curate-lint: disable" not in engine.read_text()
    assert tcc.run_concurrency_check([str(engine)]) == []
    analysis = tcc.analyze([str(engine)], tcommon.LintConfig())
    roots = {(analysis.registry.root(s), analysis.registry.root(d)) for s, d in analysis.edge_set()}
    assert ("CaptionEngine._lock", "CaptionEngine._prefix_lock") in roots
    assert ("CaptionEngine._lock", "CaptionEngine._stats_lock") in roots
    assert ("CaptionEngine._prefix_lock", "CaptionEngine._stats_lock") in roots
    assert analysis.registry.root("CaptionEngine._work_cv") == "CaptionEngine._lock"


def test_port_tree_is_concurrency_clean():
    findings = tcc.run_concurrency_check([str(REPO / "cosmos_curate_tpu_torch")])
    assert findings == [], "\n".join(f.render() for f in findings)
