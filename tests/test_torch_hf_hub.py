"""Port parity: the SDK-free hub pull (``models/hf_hub.py``) and ``models
pull-hf``, against the JAX package's, on a local fake hub (the JAX tests'
``http.server`` fake on 127.0.0.1; no other host is contacted).

Every scenario runs through both packages' functions and must give the
same files, the same errors and, through both command lines, the same exit
codes and stdout (the fake's port and the temporary paths masked):
download with the hub's linked sha256, resume from a partial file, restart
where the server ignores ``Range``, a sha256 mismatch (raised, the partial
discarded), a 404, the bearer token, repo subpaths, an existing file
verified when a sha256 is given, and the URL layout.
"""

from __future__ import annotations

import contextlib
import hashlib
import io

import pytest

from cosmos_curate_tpu.cli import main as jmain
from cosmos_curate_tpu.models import hf_hub as jhub
from cosmos_curate_tpu_torch.cli import main as tmain
from cosmos_curate_tpu_torch.models import hf_hub as thub
from tests.models.test_hf_hub import PAYLOAD, _FakeHub, fake_hub  # noqa: F401  (fixture)

HUBS = pytest.mark.parametrize("hub", [jhub, thub], ids=["jax", "port"])


@HUBS
def test_download_verifies_linked_etag(hub, fake_hub, tmp_path):
    dest = hub.download_file("repo/model", "model.safetensors", tmp_path / "m.st")
    assert dest.read_bytes() == PAYLOAD
    assert not (tmp_path / "m.st.part").exists()


@HUBS
def test_resume_from_partial(hub, fake_hub, tmp_path):
    (tmp_path / "m.st.part").write_bytes(PAYLOAD[: len(PAYLOAD) // 2])
    dest = hub.download_file("repo/model", "model.safetensors", tmp_path / "m.st")
    assert dest.read_bytes() == PAYLOAD


@HUBS
def test_resume_restarts_when_server_ignores_range(hub, fake_hub, tmp_path):
    _FakeHub.range_supported = False
    (tmp_path / "m.st.part").write_bytes(b"garbage-prefix")
    assert hub.download_file("repo/model", "model.safetensors", tmp_path / "m.st").read_bytes() == PAYLOAD


@HUBS
def test_integrity_mismatch_raises_and_discards(hub, fake_hub, tmp_path):
    with pytest.raises(hub.HubDownloadError, match="integrity"):
        hub.download_file("repo/model", "model.safetensors", tmp_path / "m.st", expected_sha256="0" * 64)
    assert not (tmp_path / "m.st").exists() and not (tmp_path / "m.st.part").exists()


@HUBS
def test_missing_file_raises(hub, fake_hub, tmp_path):
    with pytest.raises(hub.HubDownloadError, match="404"):
        hub.download_file("repo/model", "nope.bin", tmp_path / "x")


@HUBS
def test_token_rides_authorization_header(hub, fake_hub, tmp_path, monkeypatch):
    monkeypatch.setenv("HF_TOKEN", "hf_secret")
    hub.download_file("repo/model", "tokenizer.json", tmp_path / "t.json")
    assert "Bearer hf_secret" in _FakeHub.auth_seen


@HUBS
def test_repo_subpaths_preserved(hub, fake_hub, tmp_path):
    paths = hub.pull_repo_files("repo/model", ["config.json", "text_encoder/config.json"], tmp_path / "d")
    assert [p.read_bytes() for p in paths] == [b'{"top": 1}', b'{"sub": 2}']
    assert paths[1].parent.name == "text_encoder"


@HUBS
def test_existing_file_still_verified_when_sha_given(hub, fake_hub, tmp_path):
    dest = tmp_path / "t.json"
    dest.write_bytes(b"tampered")
    with pytest.raises(hub.HubDownloadError, match="integrity"):
        hub.download_file("repo/model", "tokenizer.json", dest, expected_sha256="1" * 64)
    good = hashlib.sha256(b"tampered").hexdigest()
    assert hub.download_file("repo/model", "tokenizer.json", dest, expected_sha256=good) == dest


def test_endpoint_and_url_layout_match(monkeypatch):
    monkeypatch.delenv("CURATE_HF_ENDPOINT", raising=False)
    monkeypatch.delenv("HF_ENDPOINT", raising=False)
    args = ("Qwen/Qwen2-VL-2B-Instruct", "model.safetensors", "main")
    assert thub.hub_url(*args) == jhub.hub_url(*args) == \
        "https://huggingface.co/Qwen/Qwen2-VL-2B-Instruct/resolve/main/model.safetensors"
    monkeypatch.setenv("HF_ENDPOINT", "http://mirror.internal/")
    assert thub.hub_endpoint() == jhub.hub_endpoint() == "http://mirror.internal"
    monkeypatch.setenv("CURATE_HF_ENDPOINT", "http://first.internal")
    assert thub.hub_endpoint() == jhub.hub_endpoint() == "http://first.internal"


def _cli(main, argv: list[str], root, port: int) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main.main(argv)
    return rc, out.getvalue().replace(str(root), "<root>").replace(str(port), "<port>")


# (argv, what a partial file holds first or None, expected exit code)
CLI_CASES = {
    "pull": (["model.safetensors", "tokenizer.json"], None, 0),
    "resume": (["model.safetensors"], PAYLOAD[:1000], 0),
    "sha_mismatch": (["model.safetensors", "--sha256", "0" * 64], None, 1),
    "not_found": (["nope.bin"], None, 1),
    "sha_of_two_files": (["model.safetensors", "tokenizer.json", "--sha256", "0" * 64], None, 2),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_pull_hf_command_matches_jax(case, fake_hub, tmp_path, monkeypatch):
    files, partial, want_rc = CLI_CASES[case]
    results = []
    for name, main in (("jax", jmain), ("port", tmain)):
        root = tmp_path / name
        monkeypatch.setenv("CURATE_MODEL_WEIGHTS_DIR", str(root))
        if partial is not None:
            dest = root / "hf" / "repo/model"
            dest.mkdir(parents=True)
            (dest / "model.safetensors.part").write_bytes(partial)
        rc, out = _cli(main, ["models", "pull-hf", "repo/model", *files], root, fake_hub.server_port)
        pulled = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file() and ".lock" not in p.name)
        results.append((rc, out, pulled))
    assert results[1] == results[0]
    assert results[1][0] == want_rc
    if want_rc == 0:
        assert (tmp_path / "port" / "hf" / "repo/model" / "model.safetensors").read_bytes() == PAYLOAD
