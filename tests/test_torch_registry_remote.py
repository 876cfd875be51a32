"""Port parity: the model registry's remote staging
(``models/registry.py``: ``CURATE_WEIGHTS_URI``, ``maybe_pull_remote_weights``,
``maybe_pull_tokenizer_files``, ``WeightsIntegrityError``) against the JAX
package's (``cosmos_curate_tpu/models/registry.py:124-196``, called from
``load_params`` at ``:249``), both pulling from ``tests/storage/fake_s3.py``.

The first case is the fault this slice repairs: with ``CURATE_WEIGHTS_URI``
set and nothing staged locally, the JAX embedder pulls and loads its saved
checkpoint while the port embedded with its seeded init. It compares the
two embedders in fp32 on the CPU at the whole-model bar (atol 1e-4, rtol
1e-3; the JAX model hard-codes bf16 compute, so both are rebound to fp32 as
``tests/test_torch_embedder.py`` does)."""

from __future__ import annotations

import functools
import hashlib
import multiprocessing
import threading

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cosmos_curate_tpu.models import embedder as jemb
from cosmos_curate_tpu.models import internvideo2 as jiv
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models import vit as jvit
from cosmos_curate_tpu_torch.models import embedder as temb
from cosmos_curate_tpu_torch.models import internvideo2 as tiv
from cosmos_curate_tpu_torch.models import registry as tregistry
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
from cosmos_curate_tpu_torch.storage import client as storage_client
from cosmos_curate_tpu_torch.storage.s3_rest import S3RestClient
from tests.fixtures.object_stores import object_stores  # noqa: F401

ATOL, RTOL = 1e-4, 1e-3
TINY = jemb.VIDEO_EMBED_TINY_TEST
EMBED_ID = "video-embed-tpu"
URI = "s3://weights/prefix"
REGISTRIES = {"port": tregistry, "jax": jregistry}


def _publish(model_id: str, data: bytes, *, sha256: str | None = None, name: str = "params.msgpack") -> str:
    """``data`` at ``{URI}/{model_id}/{name}`` through the port's client,
    with its ``.sha256`` sidecar (``sha256``, else the true digest)."""
    remote = f"{URI}/{model_id}/{name}"
    storage_client.write_bytes(remote, data)
    if name == "params.msgpack":
        digest = sha256 or hashlib.sha256(data).hexdigest()
        storage_client.write_bytes(f"{remote}.sha256", f"{digest}  params.msgpack\n".encode())
    return remote


def _jax_checkpoint(tmp_path, seed: int = 5) -> tuple[bytes, dict]:
    """The JAX embedder's init at ``seed`` as ``save_params`` writes it, and
    the params."""
    model = jemb.VideoEmbedModel(TINY)
    params = fnn.meta.unbox(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, TINY.num_frames, 32, 32, 3), jnp.uint8)))
    path = jregistry.save_params(EMBED_ID, params, root=tmp_path / "saved")
    return path.read_bytes(), params


@pytest.fixture
def fp32_embedders(monkeypatch):
    """Both embedders in fp32 (the JAX package caches its compiled apply per
    config: cleared around the test)."""
    monkeypatch.setattr(jemb, "ViT", functools.partial(jvit.ViT, dtype=jnp.float32))
    monkeypatch.setattr(jemb, "TemporalPooler", functools.partial(jemb.TemporalPooler, dtype=jnp.float32))
    monkeypatch.setattr(temb, "VideoEmbedModel", functools.partial(temb.VideoEmbedModel, dtype=torch.float32))
    jemb._jitted_apply.cache_clear()
    yield
    jemb._jitted_apply.cache_clear()


def _frames(seed: int, b: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (b, TINY.num_frames, 32, 32, 3), dtype=np.uint8)


def _ranged_reads(monkeypatch) -> list[tuple[str, int, int]]:
    reads: list = []
    real = S3RestClient.read_range

    def counted(self, path, start, end):
        reads.append((path, start, end))
        return real(self, path, start, end)

    monkeypatch.setattr(S3RestClient, "read_range", counted)
    return reads


def test_weights_uri_gives_the_jax_embedders_outputs(object_stores, fp32_embedders, tmp_path, monkeypatch):  # noqa: F811
    """The repaired fault: with ``CURATE_WEIGHTS_URI`` on a fake S3 holding
    the JAX embedder's saved checkpoint and an empty staging directory, the
    port's embedder pulls it (by ranged reads, through its sha256) and
    embeds as the JAX embedder does on the same pull."""
    data, _ = _jax_checkpoint(tmp_path)
    _publish(EMBED_ID, data)
    monkeypatch.setenv(tregistry.WEIGHTS_URI_ENV, URI)
    monkeypatch.setattr(tregistry, "PULL_CHUNK", 64 * 1024)
    reads = _ranged_reads(monkeypatch)
    frames = _frames(0)

    monkeypatch.setenv(tregistry.WEIGHTS_DIR_ENV, str(tmp_path / "port_weights"))
    port = temb.VideoEmbedder(TINY, device="cpu")
    port.setup()
    got = port.encode_clips(frames)
    staged = tmp_path / "port_weights" / EMBED_ID / "params.msgpack"
    assert staged.read_bytes() == data
    assert [r[1:] for r in reads] == [(s, min(s + 64 * 1024, len(data)) - 1) for s in range(0, len(data), 64 * 1024)]
    assert len(reads) > 1 and not list(staged.parent.glob("*.tmp"))

    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path / "jax_weights"))
    ref = jemb.VideoEmbedder(TINY)
    ref.setup()
    want = np.asarray(ref.encode_clips(frames))
    assert (tmp_path / "jax_weights" / EMBED_ID / "params.msgpack").read_bytes() == data
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

    # the seeded init the port fell back to before the repair is far off
    monkeypatch.delenv(tregistry.WEIGHTS_URI_ENV)
    monkeypatch.setenv(tregistry.WEIGHTS_DIR_ENV, str(tmp_path / "empty"))
    seeded = temb.VideoEmbedder(TINY, device="cpu")
    seeded.setup()
    assert np.abs(seeded.encode_clips(frames) - want).max() > 1e-2


@pytest.mark.parametrize("package", ["port", "jax"])
def test_sha256_mismatch_raises_weights_integrity_error(object_stores, tmp_path, monkeypatch, package):  # noqa: F811
    reg = REGISTRIES[package]
    data = b"\x01" * 4096
    _publish(EMBED_ID, data, sha256="0" * 64)
    monkeypatch.setenv(reg.WEIGHTS_URI_ENV, URI)
    monkeypatch.setenv(reg.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))
    with pytest.raises(reg.WeightsIntegrityError, match="sha256"):
        reg.maybe_pull_remote_weights(EMBED_ID)
    # load_params aborts too: a corrupt pull never becomes the seeded init
    with pytest.raises(reg.WeightsIntegrityError):
        reg.load_params(EMBED_ID, lambda seed: {})
    staged = tmp_path / "weights" / EMBED_ID
    assert sorted(p.name for p in staged.iterdir()) == [".staging.lock"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_absent_or_unreachable_remote_weights_fall_back_to_the_seeded_init(tmp_path, monkeypatch, package):
    """A store the backend cannot reach (no credentials) and a prefix without
    the object both leave ``load_params`` on the seeded init, with the error
    logged, in both packages. On S3 the absent object surfaces from the
    pull as the size probe's HTTP 404 (``S3Error``, not
    ``FileNotFoundError``), as in the reference."""
    reg = REGISTRIES[package]
    monkeypatch.setenv(reg.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))
    monkeypatch.setenv(reg.WEIGHTS_URI_ENV, URI)
    for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_ENDPOINT_URL"):
        monkeypatch.delenv(var, raising=False)
    assert reg.load_params(EMBED_ID, lambda seed: {"seed": seed}, seed=3) == {"seed": 3}
    from tests.fixtures.object_stores import running_object_stores

    with running_object_stores() as stores:
        for k, v in stores.env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError) as ei:
            reg.maybe_pull_remote_weights(EMBED_ID)
        assert type(ei.value).__name__ == "S3Error" and ei.value.status == 404
        assert reg.load_params(EMBED_ID, lambda seed: {"seed": seed}, seed=4) == {"seed": 4}
        assert not stores.auth_failures()
    assert not (tmp_path / "weights" / EMBED_ID / "params.msgpack").exists()


def _pull_in_child(env: dict, package: str, start, out) -> None:
    import os

    os.environ.update(env)
    reg = REGISTRIES[package]
    start.wait(60)
    out.put(str(reg.maybe_pull_remote_weights(EMBED_ID)))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_two_processes_pull_once_under_the_file_lock(object_stores, tmp_path, package):  # noqa: F811
    """Two spawned processes of one host stage the same checkpoint at once:
    the lock lets one pull it; the other finds it staged."""
    data = bytes(range(256)) * 4096  # 1 MiB: one ranged read
    _publish(EMBED_ID, data)
    gets: list[str] = []
    lock = threading.Lock()
    handler = object_stores.s3._server.RequestHandlerClass
    real_get = handler.do_GET

    def counted_get(self):
        with lock:
            gets.append(self.path)
        real_get(self)

    handler.do_GET = counted_get
    env = {**object_stores.env, "CURATE_WEIGHTS_URI": URI, "CURATE_MODEL_WEIGHTS_DIR": str(tmp_path / "weights")}
    ctx = multiprocessing.get_context("spawn")
    start, out = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=_pull_in_child, args=(env, package, start, out)) for _ in range(2)]
    try:
        for p in procs:
            p.start()
        start.set()
        paths = [out.get(timeout=120) for _ in procs]
    finally:
        for p in procs:
            p.join(60)
        handler.do_GET = real_get
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    staged = tmp_path / "weights" / EMBED_ID / "params.msgpack"
    assert paths == [str(staged)] * 2 and staged.read_bytes() == data
    assert sum(path.endswith(f"/{EMBED_ID}/params.msgpack") for path in gets) == 1, gets


def test_tokenizer_files_pulled_as_the_reference_pulls_them(object_stores, tmp_path, monkeypatch):  # noqa: F811
    """The sidecar files a prefix holds are pulled; those it lacks stay
    unstaged, in both packages."""
    files = {"vocab.json": b'{"a": 0}', "merges.txt": b"#version: 0.2\na b\n"}
    for name, body in files.items():
        _publish("clip-text-b-tpu", body, name=name)
    for package, reg in REGISTRIES.items():
        monkeypatch.setenv(reg.WEIGHTS_URI_ENV, URI)
        monkeypatch.setenv(reg.WEIGHTS_DIR_ENV, str(tmp_path / package))
        reg.maybe_pull_tokenizer_files("clip-text-b-tpu")
        staged = tmp_path / package / "clip-text-b-tpu"
        assert {p.name: p.read_bytes() for p in staged.iterdir()} == files, package


def test_required_weights_are_pulled_before_the_guard(object_stores, tmp_path, monkeypatch):  # noqa: F811
    """``IV2Embedder(require_weights=True)`` refuses without a checkpoint;
    with ``CURATE_WEIGHTS_URI`` holding the JAX tower's, it pulls and loads
    it instead of refusing."""
    tiny_id = "internvideo2-tiny-test"
    model = jiv.InternVideo2Tower(jiv.IV2_TINY_TEST)
    params = fnn.meta.unbox(model.init(jax.random.PRNGKey(3), jnp.zeros((1, 2, 28, 28, 3), jnp.uint8)))
    data = jregistry.save_params(tiny_id, params, root=tmp_path / "saved").read_bytes()
    monkeypatch.setenv(tregistry.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))
    emb = tiv.IV2Embedder(tiv.IV2_TINY_TEST, model_id=tiny_id, require_weights=True, device="cpu")
    with pytest.raises(RuntimeError, match="requires trained weights"):
        emb.setup()
    _publish(tiny_id, data)
    monkeypatch.setenv(tregistry.WEIGHTS_URI_ENV, URI)
    emb.setup()
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    got = emb.model.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(value), err_msg=name)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_stage_weights_on_node_pulls_every_model(object_stores, tmp_path, monkeypatch, package):  # noqa: F811
    reg = REGISTRIES[package]
    _publish(EMBED_ID, b"a" * 100)
    _publish("t5-encoder-tpu", b"b" * 50)
    monkeypatch.setenv(reg.WEIGHTS_URI_ENV, URI)
    monkeypatch.setenv(reg.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))
    reg.stage_weights_on_node([EMBED_ID, "t5-encoder-tpu"])
    assert (tmp_path / "weights" / EMBED_ID / "params.msgpack").read_bytes() == b"a" * 100
    assert (tmp_path / "weights" / "t5-encoder-tpu" / "params.msgpack").read_bytes() == b"b" * 50
    # a model the prefix lacks: the size probe's 404, in both packages
    with pytest.raises(RuntimeError, match="HTTP 404"):
        reg.stage_weights_on_node(["clip-text-b-tpu"])
    assert (tmp_path / "weights" / "clip-text-b-tpu").is_dir()
