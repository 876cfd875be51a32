"""Port parity: the ``models`` command (``cli/models_cli.py``) and the
checkpoints its ``init-random`` writes, against the JAX package's.

- ``list`` and ``stage``: the same stdout (the weights root masked) and
  exit codes as the JAX command line; ``list`` in fresh processes, as a
  user runs it (each package's registry also holds the ids of the model
  modules a process has imported), with nothing staged and with one
  checkpoint staged; ``stage`` with an unknown id (2), a missing file (2)
  and a real one (0, copied); ``models`` alone (2).
- ``init-random``: an unknown id exits 2 with the JAX command's message.
  Each of the reference's six ids: the names and shapes the port's seeded
  model writes are those of ``jax.eval_shape`` of the JAX command's own
  init, at full size; and, with each id's configuration cut to its tiny
  test configuration in both packages, the file the port's command writes
  loads into the JAX package through ``registry.load_params(...,
  require=True)`` (no fallback to the seeded init) with the port model's
  values exactly, and into the port's model with ``require=True``. The
  same seed writes the same bytes; another seed other bytes.
- ``state_dict_to_flax`` inverts ``flax_to_state_dict`` exactly on each id's
  JAX seeded init at the tiny configuration.
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import flax
import jax
import numpy as np
import pytest
import torch

from cosmos_curate_tpu.cli import main as jmain
from cosmos_curate_tpu.cli import models_cli as jmodels_cli
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu_torch.cli import main as tmain
from cosmos_curate_tpu_torch.cli import models_cli as tmodels_cli
from cosmos_curate_tpu_torch.models import registry as tregistry
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict, state_dict_to_flax

REPO = Path(__file__).resolve().parents[1]
IDS = ("transnetv2-tpu", "clip-vit-b16-tpu", "aesthetics-mlp-tpu", "video-embed-tpu", "caption-vlm-tpu",
       "t5-encoder-tpu")
# (module, attribute, tiny attribute) the builders read, in each package
TINY = {
    "transnetv2-tpu": [],
    "aesthetics-mlp-tpu": [],
    "clip-vit-b16-tpu": [("models.vit", "VIT_B_16", "VIT_TINY_TEST")],
    "video-embed-tpu": [("models.embedder", "VIDEO_EMBED_BASE", "VIDEO_EMBED_TINY_TEST")],
    "caption-vlm-tpu": [("models.vlm", "VLM_BASE", "VLM_TINY_TEST")],
    "t5-encoder-tpu": [("models.t5", "T5_BASE", "T5_TINY_TEST")],
}


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _run_cli(pkg: str, argv: list[str], root: Path) -> tuple[int, str]:
    env = {**os.environ, "CURATE_MODEL_WEIGHTS_DIR": str(root), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-m", f"{pkg}.cli.main", *argv], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    return out.returncode, out.stdout.replace(str(root), "<root>")


def _in_process(main, argv: list[str], root: Path) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main.main(argv)
    return rc, out.getvalue().replace(str(root), "<root>")


@pytest.mark.parametrize("staged", [False, True])
def test_list_matches_jax(staged, tmp_path):
    results = []
    for pkg in ("cosmos_curate_tpu", "cosmos_curate_tpu_torch"):
        root = tmp_path / pkg
        if staged:
            (root / "tracker-siamese-tpu").mkdir(parents=True)
            (root / "tracker-siamese-tpu" / "params.msgpack").write_bytes(b"\0" * (3 << 20))
        results.append(_run_cli(pkg, ["models", "list"], root))
    assert results[1] == results[0]
    rc, out = results[1]
    assert rc == 0 and len(out.splitlines()) == len(IDS) + 12
    assert ("staged (3 MiB)" in out) == staged


@pytest.mark.parametrize("case", ["unknown_id", "missing_file", "staged", "bare_group"])
def test_stage_matches_jax(case, tmp_path, monkeypatch):
    ckpt = tmp_path / "ckpt.msgpack"
    ckpt.write_bytes(b"weights")
    argv = {"unknown_id": ["models", "stage", "no-such-model", str(ckpt)],
            "missing_file": ["models", "stage", "transnetv2-tpu", str(tmp_path / "absent.msgpack")],
            "staged": ["models", "stage", "transnetv2-tpu", str(ckpt)],
            "bare_group": ["models"]}[case]
    results = []
    for name, main in (("jax", jmain), ("port", tmain)):
        root = tmp_path / name
        monkeypatch.setenv("CURATE_MODEL_WEIGHTS_DIR", str(root))
        rc, out = _in_process(main, argv, root)
        copied = (root / "transnetv2-tpu" / "params.msgpack")
        results.append((rc, out if case != "bare_group" else "", copied.exists() and copied.read_bytes()))
    assert results[1] == results[0]
    assert results[1][0] == (0 if case == "staged" else 2)
    assert results[1][2] == (b"weights" if case == "staged" else False)


def test_init_random_refuses_an_unknown_id_as_jax_does(tmp_path, monkeypatch):
    monkeypatch.setenv("CURATE_MODEL_WEIGHTS_DIR", str(tmp_path))
    argv = ["models", "init-random", "no-such-model"]
    assert _in_process(tmain, argv, tmp_path) == _in_process(jmain, argv, tmp_path)
    assert _in_process(tmain, argv, tmp_path)[0] == 2
    assert sorted(tmodels_cli.init_builders()) == sorted(jmodels_cli._init_builders()) == sorted(IDS)


@pytest.mark.parametrize("model_id", IDS)
def test_full_size_names_and_shapes_match_jax(model_id):
    want = {k: tuple(v.shape) for k, v in _flat(flax.linen.unbox(
        jax.eval_shape(lambda: jmodels_cli._init_builders()[model_id](0)))).items()}
    module = tmodels_cli.init_builders()[model_id]()
    got = {k: tuple(v.shape) for k, v in _flat(state_dict_to_flax(module)).items()}
    assert got == want


@pytest.fixture()
def tiny(request, monkeypatch):
    """The id's builders in both packages cut to its tiny configuration."""
    import importlib

    for module, attr, small in TINY[request.param]:
        for pkg in ("cosmos_curate_tpu", "cosmos_curate_tpu_torch"):
            mod = importlib.import_module(f"{pkg}.{module}")
            monkeypatch.setattr(mod, attr, getattr(mod, small))
    return request.param


@pytest.mark.parametrize("tiny", IDS, indirect=True)
def test_init_random_checkpoint_loads_in_both_packages(tiny, tmp_path, monkeypatch):
    model_id = tiny
    monkeypatch.setenv("CURATE_MODEL_WEIGHTS_DIR", str(tmp_path))
    rc, out = _in_process(tmain, ["models", "init-random", model_id, "--seed", "3"], tmp_path)
    path = tmp_path / model_id / "params.msgpack"
    assert rc == 0 and out == f"wrote <root>/{model_id}/params.msgpack\n"
    written = tmodels_cli.seeded(tmodels_cli.init_builders()[model_id](), 3)
    want = state_dict_to_flax(written)
    # the JAX package: its own init's structure as the template, no fallback
    template = jax.eval_shape(lambda: jmodels_cli._init_builders()[model_id](0))
    restored = flax.linen.unbox(jregistry.load_params(model_id, lambda s: template, require=True))
    got = _flat(restored)
    assert got.keys() == _flat(want).keys()
    for k, v in _flat(want).items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    # the port: its model filled from the file
    fresh = tmodels_cli.init_builders()[model_id]()
    tregistry.load_module(fresh, model_id, require=True)
    for k, v in written.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v.float() if v.is_floating_point() else v), k
    # the seed decides the bytes
    first = path.read_bytes()
    _in_process(tmain, ["models", "init-random", model_id, "--seed", "3"], tmp_path)
    assert path.read_bytes() == first
    _in_process(tmain, ["models", "init-random", model_id, "--seed", "4"], tmp_path)
    assert path.read_bytes() != first


@pytest.mark.parametrize("tiny", IDS, indirect=True)
def test_state_dict_to_flax_inverts_each_ids_jax_init(tiny):
    jparams = jax.jit(lambda: jmodels_cli._init_builders()[tiny](0))()
    tree = jax.tree_util.tree_map(np.asarray, flax.linen.unbox(jparams))
    module = tmodels_cli.init_builders()[tiny]()
    module.load_state_dict(flax_to_state_dict(tree))
    got = state_dict_to_flax(module, flax_to_state_dict(tree))
    flat_got, flat_want = _flat(got), _flat(tree)
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        assert flat_got[k].dtype == v.dtype
        np.testing.assert_array_equal(flat_got[k], v, err_msg=k)
