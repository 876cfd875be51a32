"""Port parity: the AST linter (``analysis/ast_lint.py``, ``analysis/rules/``,
``analysis/common.py``) and the ``lint`` command against the JAX package's.

- Every fixture source of the reference's rule tests
  (``tests/analysis/test_ast_lint.py``, ``test_ad_hoc_backoff.py``,
  ``test_blocking_in_async.py``, ``test_sync_readback.py``,
  ``test_concurrency_check.py``), read out of those files, goes through
  both linters at every directory the rules scope by: the six hygiene rules
  (lock-discipline, thread-lifecycle, blocking-in-async, min-python,
  silent-swallow, ad-hoc-backoff) give the same findings (file, line, rule
  id, message; the package's own name aside), and the same suppressions.
- The three rules aimed at torch (hardcoded-device-count, jit-transfer,
  sync-readback) flag each torch-idiom translation of the reference's
  fixtures at the lines where the JAX rule flags the JAX fixture, and pass
  the clean ones.
- The config loader, the rule catalogue (the two mesh rules wait for the
  mesh layer) and the driver's errors match the reference's.
- The port's own tree is lint-clean: ``lint --concurrency --schema
  cosmos_curate_tpu_torch`` exits 0; ``lint --shard-check`` exits 2 naming
  ROADMAP A7.
"""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from cosmos_curate_tpu.analysis import ast_lint as jlint
from cosmos_curate_tpu.analysis import common as jcommon
from cosmos_curate_tpu.analysis import rules as jrules
from cosmos_curate_tpu_torch.analysis import ast_lint as tlint
from cosmos_curate_tpu_torch.analysis import common as tcommon
from cosmos_curate_tpu_torch.analysis import rules as trules

REPO = Path(__file__).resolve().parents[1]
FIXTURE_FILES = ("test_ast_lint.py", "test_ad_hoc_backoff.py", "test_blocking_in_async.py", "test_sync_readback.py",
                 "test_concurrency_check.py")
HYGIENE = ("lock-discipline", "thread-lifecycle", "blocking-in-async", "min-python", "silent-swallow",
           "ad-hoc-backoff")
TORCH_AIMED = ("hardcoded-device-count", "jit-transfer", "sync-readback")
# every directory a rule scopes by: engine/ (lock-discipline,
# silent-swallow), storage/retry.py (ad-hoc-backoff's exemption), tests/
# (excluded by two rules), models/ and stages (sync-readback), parallel/
# (device-count's exemption)
RELS = ("engine/snippet.py", "storage/snippet.py", "storage/retry.py", "service/snippet.py", "ops/snippet.py",
        "tests/snippet.py")


def fixture_sources(names=FIXTURE_FILES) -> dict[str, str]:
    """Every multi-line string of the reference's rule tests that parses
    as Python, dedented: the fixtures, by ``file:line``."""
    out = {}
    for name in names:
        path = REPO / "tests" / "analysis" / name
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and node.value.count("\n") >= 2:
                code = textwrap.dedent(node.value)
                try:
                    tree = ast.parse(code)
                except SyntaxError:
                    continue
                if any(isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Import,
                                      ast.ImportFrom, ast.Assign)) for n in tree.body):
                    out[f"{name}:{node.lineno}"] = code
    return out


FIXTURES = fixture_sources()


def _findings(lint_mod, rules_mod, root: Path, rel: str, code: str, rule_ids, floor=(3, 10)):
    f = root / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(code)
    cfg_cls = (jcommon if lint_mod is jlint else tcommon).LintConfig
    rules = [r for r in rules_mod.all_rules() if r.rule_id in rule_ids]
    found = lint_mod.lint_file(f, cfg_cls(python_floor=floor), rules, root=root)
    return [(x.file, x.line, x.rule, x.message.replace("cosmos_curate_tpu_torch", "cosmos_curate_tpu"),
             x.severity.value) for x in found]


def test_fixtures_were_found():
    assert len(FIXTURES) >= 50
    assert {k.split(":")[0] for k in FIXTURES} == set(FIXTURE_FILES)


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_hygiene_rules_match_jax(fixture, tmp_path):
    code = FIXTURES[fixture]
    for floor in ((3, 10), (3, 11)):
        for rel in RELS:
            want = _findings(jlint, jrules, tmp_path / "jax", rel, code, HYGIENE, floor)
            got = _findings(tlint, trules, tmp_path / "port", rel, code, HYGIENE, floor)
            assert got == want, (rel, floor)
    assert tcommon.parse_suppressions(code) == jcommon.parse_suppressions(code)


# (JAX fixture, torch translation, path): the translation keeps the JAX
# fixture's line structure, so the flagged lines must be the same
TORCH_CASES = {
    # hardcoded-device-count (tests/analysis/test_mesh_rules.py)
    "device_count:len": ("hardcoded-device-count", "models/snippet.py", """
        import jax

        n = len(jax.devices())
        """, """
        import torch

        n = len([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
        """),
    "device_count:calls": ("hardcoded-device-count", "models/snippet.py", """
        import jax

        shape = (jax.device_count(), jax.local_device_count())
        """, """
        from torch import cuda

        shape = (cuda.device_count(), cuda.device_count() // 2)
        """),
    "device_count:slice": ("hardcoded-device-count", "models/snippet.py", """
        import jax

        devs = jax.devices()[: sp_size]
        """, """
        import torch

        devs = list(range(torch.cuda.device_count()))[: sp_size]
        """),
    "device_count:probe_clean": ("hardcoded-device-count", "models/snippet.py", """
        import jax

        platform = jax.devices()[0].platform
        tpus = len([d for d in jax.devices() if d.platform == "tpu"])
        """, """
        import torch

        platform = torch.cuda.get_device_name(0)
        gpus = torch.cuda.is_available()
        """),
    "device_count:parallel_exempt": ("hardcoded-device-count", "parallel/snippet.py", """
        import jax

        n = len(jax.devices())
        """, """
        import torch

        n = torch.cuda.device_count()
        """),
    # jit-transfer (tests/analysis/test_ast_lint.py TestJitTransfer)
    "jit_transfer:item": ("jit-transfer", "ops/snippet.py", """
        import jax

        @jax.jit
        def f(x):
            return x.sum().item()
        """, """
        import torch

        @torch.compile
        def f(x):
            return x.sum().item()
        """),
    "jit_transfer:cast": ("jit-transfer", "ops/snippet.py", """
        import functools
        import jax

        @functools.partial(jax.jit, static_argnames=())
        def f(x):
            loss = x.mean()
            return float(loss)
        """, """
        import functools
        import torch

        @functools.partial(torch.compile, dynamic=False)
        def f(x):
            loss = x.mean()
            return float(loss)
        """),
    "jit_transfer:shape_clean": ("jit-transfer", "ops/snippet.py", """
        import jax

        @jax.jit
        def f(x):
            t, h, w = x.shape
            band = max(1, int(h * 0.2))
            return x[:, :band]
        """, """
        import torch

        @torch.compile(fullgraph=True)
        def f(x):
            t, h, w = x.shape
            band = max(1, int(h * 0.2))
            return x[:, :band]
        """),
    "jit_transfer:asarray": ("jit-transfer", "ops/snippet.py", """
        import jax
        import numpy as np

        @jax.jit
        def f(x):
            return np.asarray(x)
        """, """
        import torch
        import numpy as np

        @torch.compile
        def f(x):
            return np.asarray(x)
        """),
    "jit_transfer:graph_capture": ("jit-transfer", "ops/snippet.py", """
        import jax

        @jax.jit
        def f(x):
            return x.sum().item()
        """, """
        import torch

        def f(g, x):
            with torch.cuda.graph(g):
                y = x.sum().cpu()
        """),
    "jit_transfer:unjitted_clean": ("jit-transfer", "ops/snippet.py", """
        def f(x):
            return x.sum().item()
        """, """
        def f(x):
            return x.sum().item()
        """),
    # sync-readback (tests/analysis/test_sync_readback.py)
    "sync_readback:direct": ("sync-readback", "cosmos_curate_tpu/models/snippet.py", """
        import jax
        import numpy as np

        fn = jax.jit(lambda x: x)

        def encode(x):
            return np.asarray(fn(x))
        """, """
        import torch
        import numpy as np

        fn = torch.compile(torch.nn.Identity())

        def encode(x):
            return fn(x).cpu().numpy()
        """),
    "sync_readback:factory": ("sync-readback", "cosmos_curate_tpu/models/snippet.py", """
        import jax
        import numpy as np

        def _jitted_apply(cfg):
            return jax.jit(lambda p, x: x)

        class M:
            def setup(self):
                self._apply = _jitted_apply(None)

            def encode(self, params, padded, n):
                return np.asarray(self._apply(params, padded))[:n]
        """, """
        import torch
        import numpy as np

        def _compiled_forward(model):
            return torch.compile(model)

        class M:
            def setup(self):
                self._run = _compiled_forward(None)

            def encode(self, padded, n):
                return self._run(padded).float().cpu().numpy()[:n]
        """),
    "sync_readback:convention": ("sync-readback", "cosmos_curate_tpu/models/snippet.py", """
        import numpy as np

        class M:
            def encode(self, x):
                return np.asarray(self._apply(self._params, x))
        """, """
        import numpy as np

        class M:
            def encode(self, x):
                return self.model(x).item()
        """),
    "sync_readback:stage": ("sync-readback", "cosmos_curate_tpu/pipelines/video/stages/snippet.py", """
        import jax

        def fetch(y):
            return jax.device_get(y)
        """, """
        import numpy as np

        def fetch(self, y):
            return np.asarray(self._forward(y))
        """),
    "sync_readback:plain_clean": ("sync-readback", "cosmos_curate_tpu/models/snippet.py", """
        import numpy as np

        def drain(results):
            return [np.asarray(r) for r in results]

        def coerce(self, ids):
            return np.asarray(ids, np.int32)
        """, """
        import numpy as np

        def drain(results):
            return [r.cpu().numpy() for r in results]

        def coerce(self, ids):
            return np.asarray(ids, np.int32)
        """),
    "sync_readback:non_jit_clean": ("sync-readback", "cosmos_curate_tpu/models/snippet.py", """
        import numpy as np

        def build(frames):
            return np.asarray(frames.tolist())
        """, """
        import numpy as np

        def build(frames):
            return np.asarray(frames.tolist())
        """),
    "sync_readback:device_pipeline_exempt": ("sync-readback", "cosmos_curate_tpu/models/device_pipeline.py", """
        import jax
        import numpy as np

        fn = jax.jit(lambda x: x)

        def drain(x):
            return np.asarray(fn(x))
        """, """
        import torch
        import numpy as np

        fn = torch.compile(torch.nn.Identity())

        def drain(x):
            return fn(x).cpu().numpy()
        """),
    "sync_readback:out_of_scope": ("sync-readback", "cosmos_curate_tpu/dedup/snippet.py", """
        import jax
        import numpy as np

        fn = jax.jit(lambda x: x)

        def helper(x):
            return np.asarray(fn(x))
        """, """
        import torch
        import numpy as np

        fn = torch.compile(torch.nn.Identity())

        def helper(x):
            return fn(x).cpu().numpy()
        """),
}


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_torch_aimed_rule_flags_the_translation_where_jax_flags(case, tmp_path):
    rule, rel, jax_code, torch_code = TORCH_CASES[case]
    jax_code, torch_code = textwrap.dedent(jax_code), textwrap.dedent(torch_code)
    want = _findings(jlint, jrules, tmp_path / "jax", rel, jax_code, (rule,))
    port_rel = rel.replace("cosmos_curate_tpu/", "cosmos_curate_tpu_torch/")
    got = _findings(tlint, trules, tmp_path / "port", port_rel, torch_code, (rule,))
    assert [line for _, line, _, _, _ in got] == [line for _, line, _, _, _ in want], (got, want)
    assert all(r == rule for _, _, r, _, _ in got)
    if case.endswith("clean") or case.endswith("exempt") or case.endswith("out_of_scope"):
        assert want == []


def test_torch_aimed_rules_ignore_the_jax_idiom(tmp_path):
    """The port's three rules read torch, not JAX: the reference's flagged
    JAX fixtures are clean under them."""
    for case, (rule, rel, jax_code, _) in TORCH_CASES.items():
        port_rel = rel.replace("cosmos_curate_tpu/", "cosmos_curate_tpu_torch/")
        if rule == "sync-readback" and "self._apply(" in jax_code:
            continue  # the forward-holder naming convention is shared
        assert _findings(tlint, trules, tmp_path, port_rel, textwrap.dedent(jax_code), (rule,)) == [], case


def test_rule_catalogue_matches_jax_without_the_mesh_rules():
    jids = [r.rule_id for r in jrules.all_rules()]
    tids = [r.rule_id for r in trules.all_rules()]
    assert tids == [r for r in jids if r not in ("mesh-axis-literal", "sharding-constraint-outside-jit")]
    jdesc = {r.rule_id: r.description for r in jrules.all_rules()}
    for r in trules.all_rules():
        if r.rule_id in HYGIENE:
            assert r.description == jdesc[r.rule_id]


def test_config_loader_matches_jax(tmp_path):
    assert tcommon.load_config() == tcommon.LintConfig(**vars(jcommon.load_config()))
    text = ('[project]\nrequires-python = ">=3.11"\n[tool.curate-lint]\nenable = ["min-python"]\n'
            'disable = ["x"]\nexclude = ["a/"]\npython-floor = "3.12"\nshard-hbm-gb = "nope"\n')
    (tmp_path / "pyproject.toml").write_text(text)
    got, want = tcommon.load_config(tmp_path / "pyproject.toml"), jcommon.load_config(tmp_path / "pyproject.toml")
    assert vars(got) == vars(want)
    assert got.python_floor == (3, 12) and got.rule_enabled("min-python") and not got.rule_enabled("x")
    assert tcommon._toml_tables(text) == jcommon._toml_tables(text)
    assert tcommon.find_pyproject() == jcommon.find_pyproject() == REPO / "pyproject.toml"


@pytest.mark.parametrize("error", ["unknown_rule", "missing_target", "not_python"])
def test_driver_errors_match_jax(error, tmp_path):
    (tmp_path / "notes.txt").write_text("x")
    calls = {"unknown_rule": dict(paths=[str(tmp_path)], rule_ids=["no-such-rule"]),
             "missing_target": dict(paths=[str(tmp_path / "absent.py")]),
             "not_python": dict(paths=[str(tmp_path / "notes.txt")])}[error]
    with pytest.raises(ValueError) as want:
        jlint.run_lint(**calls)
    with pytest.raises(ValueError) as got:
        tlint.run_lint(**calls)
    assert str(got.value) == str(want.value)


def test_syntax_error_reported_as_finding(tmp_path):
    got = _findings(tlint, trules, tmp_path, "engine/snippet.py", "def f(:\n", HYGIENE)
    assert got == _findings(jlint, jrules, tmp_path, "engine/snippet.py", "def f(:\n", HYGIENE)
    assert [r for _, _, r, _, _ in got] == ["parse-error"]


def test_logging_level_check_keeps_the_floor(monkeypatch):
    """Fault repaired with this slice: the port's log-level check called
    ``logging.getLevelNamesMapping`` (3.11+) unguarded under the 3.10
    floor, which ``min-python`` flags; it now falls back as the reference
    does, and an unknown level still falls back to INFO."""
    import logging

    from cosmos_curate_tpu_torch.utils import logging as tlog

    monkeypatch.delattr(logging, "getLevelNamesMapping", raising=False)
    monkeypatch.setattr(tlog, "_CONFIGURED", False)
    monkeypatch.setenv("CURATE_LOG_LEVEL", "debug")
    root = logging.getLogger("cosmos_curate_tpu_torch")
    saved = root.level, list(root.handlers)
    try:
        tlog._configure_root()
        assert root.level == logging.DEBUG
    finally:
        root.setLevel(saved[0])
        root.handlers[:] = saved[1]
    assert _findings(tlint, trules, REPO, "cosmos_curate_tpu_torch/utils/logging.py",
                     (REPO / "cosmos_curate_tpu_torch/utils/logging.py").read_text(), ("min-python",)) == []


def _cli(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", "lint", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_port_tree_is_lint_clean():
    out = _cli("--concurrency", "--schema", "cosmos_curate_tpu_torch")
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout == "" and "curate-lint: clean (1 target(s))" in out.stderr


def test_shard_check_refused_naming_the_mesh_layer():
    out = _cli("--shard-check", "--mesh", "data=2,seq=2", "--hbm-gb", "16")
    assert out.returncode == 2 and "ROADMAP queue A item 7" in out.stderr and out.stdout == ""


def test_list_rules_and_usage_errors():
    out = _cli("--list-rules")
    assert out.returncode == 0
    listed = [line.split()[0] for line in out.stdout.splitlines() if not line.startswith("(pass)")]
    assert listed == [r.rule_id for r in trules.all_rules()]
    bad = _cli("--update", "cosmos_curate_tpu_torch/analysis")
    assert bad.returncode == 2 and "--update requires --schema" in bad.stderr


def test_findings_and_json_output(tmp_path):
    """A finding fails the gate with exit 1; ``--json`` prints one NDJSON
    object a finding, as the reference's."""
    f = tmp_path / "engine" / "snippet.py"
    f.parent.mkdir()
    f.write_text("import time\n\ndef fetch():\n    for attempt in range(4):\n        time.sleep(2.0**attempt)\n")
    out = _cli("--json", str(f))
    assert out.returncode == 1
    import json

    (line,) = out.stdout.splitlines()
    assert json.loads(line)["rule"] == "ad-hoc-backoff" and json.loads(line)["line"] == 5
