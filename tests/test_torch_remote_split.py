"""Port parity: the split, dedup and shard on object stores.

Both packages run the same calls against the same fakes
(``tests/storage/fake_*.py``, through ``tests/fixtures/object_stores.py``):

- ``run_split`` at the tiny widths from ``s3://`` to ``az://``, with a tiny
  video embedder whose checkpoint (the JAX embedder's, saved by the JAX
  registry) each package pulls from ``CURATE_WEIGHTS_URI`` into its own
  empty staging directory. Both embedders are rebound to fp32, as in
  ``tests/test_torch_embedder.py``, so the embeddings compare at the
  whole-model bar (atol 1e-4, rtol 1e-3). The relative file sets, the clip
  bytes (cv2's codec in both packages, as in ``tests/test_torch_split.py``)
  and the metas are equal; a second run discovers no video;
- ``run_dedup`` and ``run_shard`` from those outputs to ``gs://``: the dedup
  CSV equal as a set (the port given the JAX seeding's first row), every
  shard member equal (embeddings within the bar);
- ``local split`` in a subprocess from ``s3://`` to ``gs://``.

Every request the two packages sign is verified by the fakes: a refused
signature fails the test."""

from __future__ import annotations

import csv
import functools
import hashlib
import io
import json
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import embedder as jemb
from cosmos_curate_tpu.models import vit as jvit
from cosmos_curate_tpu.pipelines.video import dedup as jdedup
from cosmos_curate_tpu.pipelines.video import shard as jshard
from cosmos_curate_tpu.pipelines.video import split as jsplit
from cosmos_curate_tpu.pipelines.video.stages import embedding as jembed
from cosmos_curate_tpu_torch.core.runner import SequentialRunner, default_runner
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import embedder as temb
from cosmos_curate_tpu_torch.models import registry as tregistry
from cosmos_curate_tpu_torch.pipelines.video import dedup as tdedup
from cosmos_curate_tpu_torch.pipelines.video import shard as tshard
from cosmos_curate_tpu_torch.pipelines.video import split as tsplit
from cosmos_curate_tpu_torch.pipelines.video.input_discovery import discover_split_tasks
from cosmos_curate_tpu_torch.pipelines.video.stages import embedding as tembed
from cosmos_curate_tpu_torch.storage import client as storage_client
from tests.fixtures.media import make_scene_video
from tests.fixtures.object_stores import running_object_stores
from tests.fixtures.observability import observability_state, preserved_observability_state  # noqa: F401
from tests.test_torch_dedup import port_first_from, record_jax_picks
from tests.test_torch_registry_remote import _jax_checkpoint

ATOL, RTOL = 1e-4, 1e-3
TINY = jemb.VIDEO_EMBED_TINY_TEST
EMBED_ID = "video-embed-tpu"
INPUT = "s3://in/videos"
WEIGHTS = "s3://weights/v1"
SPLIT = dict(fixed_stride_len_s=1.0, min_clip_len_s=0.5, extract_fps=(8.0,), extract_resize_hw=(32, 32))
# summary keys that depend on the clock
CLOCK_KEYS = ("timestamp", "pipeline_run_time_s", "video_hours_per_day_per_chip")


@pytest.fixture(scope="module", autouse=True)
def _cv2_codec_and_fp32():
    """Both packages on cv2's codec (it repeats itself bit for bit) and both
    embedders in fp32."""
    from cosmos_curate_tpu.video import h264 as jh264
    from cosmos_curate_tpu_torch.video import h264 as th264

    mp = pytest.MonkeyPatch()
    mp.setattr(jh264, "_probe_result", False)
    mp.setattr(th264, "_probe_result", False)
    mp.setattr(jemb, "ViT", functools.partial(jvit.ViT, dtype=jnp.float32))
    mp.setattr(jemb, "TemporalPooler", functools.partial(jemb.TemporalPooler, dtype=jnp.float32))
    mp.setattr(temb, "VideoEmbedModel", functools.partial(temb.VideoEmbedModel, dtype=torch.float32))
    jemb._jitted_apply.cache_clear()  # the JAX package compiles its apply once per config
    yield
    mp.undo()
    jemb._jitted_apply.cache_clear()


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The fakes with the environment set, the input videos on ``s3://``
    and the JAX embedder's checkpoint (with its sha256) under
    ``CURATE_WEIGHTS_URI``."""
    mp = pytest.MonkeyPatch()
    with running_object_stores() as s:
        for k, v in s.env.items():
            mp.setenv(k, v)
        mp.setenv(tregistry.WEIGHTS_URI_ENV, WEIGHTS)
        mp.delenv("CURATE_RUNNER", raising=False)
        local = tmp_path_factory.mktemp("videos")
        for i, scenes in enumerate((2, 3)):
            make_scene_video(local / f"video {i}.mp4", scene_len_frames=24, num_scenes=scenes)
        (local / "notes.txt").write_text("not a video")
        for p in sorted(local.iterdir()):
            storage_client.write_bytes(f"{INPUT}/{p.name}", p.read_bytes())
        data, _ = _jax_checkpoint(tmp_path_factory.mktemp("ckpt"))
        storage_client.write_bytes(f"{WEIGHTS}/{EMBED_ID}/params.msgpack", data)
        storage_client.write_bytes(f"{WEIGHTS}/{EMBED_ID}/params.msgpack.sha256",
                                   hashlib.sha256(data).hexdigest().encode())
        try:
            yield s
            assert not s.auth_failures(), s.auth_failures()
        finally:
            mp.undo()


def _embed_stage(package: str):
    if package == "jax":
        return jembed.ClipEmbeddingStage(variant="video", video_cfg=TINY,
                                         extraction=jdata.FrameExtractionSignature("fps", 8.0))
    return tembed.ClipEmbeddingStage(variant="video", video_cfg=TINY,
                                     extraction=tdata.FrameExtractionSignature("fps", 8.0), device="cpu")


def _split(package: str, out: str, weights_dir: Path, runner=None) -> dict:
    """One package's run_split from ``INPUT`` to ``out``, its staging
    directory empty at the start."""
    mp = pytest.MonkeyPatch()
    mp.setenv(tregistry.WEIGHTS_DIR_ENV, str(weights_dir))
    try:
        if package == "jax":
            with preserved_observability_state():
                return jsplit.run_split(jsplit.SplitPipelineArgs(input_path=INPUT, output_path=out,
                                                                 extra_stages=[_embed_stage("jax")], **SPLIT),
                                        runner=JSequentialRunner())
        return tsplit.run_split(tsplit.SplitPipelineArgs(input_path=INPUT, output_path=out, device="cpu",
                                                         extra_stages=[_embed_stage("port")], **SPLIT),
                                runner=runner or SequentialRunner())
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_remote(stores, tmp_path_factory) -> tuple[str, dict]:
    out = "az://out/jax"
    weights = tmp_path_factory.mktemp("jax_weights")
    summary = _split("jax", out, weights)
    assert (weights / EMBED_ID / "params.msgpack").exists()
    return out, summary


def _remote_files(root: str) -> dict[str, bytes]:
    client = storage_client.get_storage_client(root)
    return {rel: client.read_bytes(f"{root}/{rel}") for rel in client.list_relative(root)}


def _counts(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in CLOCK_KEYS}


def _embeddings(files: dict[str, bytes]) -> dict[str, np.ndarray]:
    rows = {}
    for rel, data in files.items():
        if rel.startswith(f"embeddings/{EMBED_ID}/"):
            table = pq.read_table(io.BytesIO(data)).to_pydict()
            rows.update({u: np.asarray(e, np.float32) for u, e in zip(table["clip_uuid"], table["embedding"])})
    return rows


def _assert_split_outputs_match(files: dict[str, bytes], j_files: dict[str, bytes]) -> None:
    assert set(files) == set(j_files)
    embs, j_embs = _embeddings(files), _embeddings(j_files)
    assert len(embs) == 5 and set(embs) == set(j_embs)
    for uuid, j_emb in j_embs.items():
        np.testing.assert_allclose(embs[uuid], j_emb, atol=ATOL, rtol=RTOL, err_msg=uuid)
    for rel, data in j_files.items():
        if rel.startswith(("metas/", "processed_videos/")):
            assert json.loads(files[rel]) == json.loads(data), rel
        elif rel.startswith("clips/"):
            assert files[rel] == data, rel


@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_remote_split_matches_jax(stores, jax_remote, runner, tmp_path):
    j_out, j_summary = jax_remote
    out = f"az://out/port-{runner}"
    summary = _split("port", out, tmp_path / "weights", SequentialRunner() if runner == "sequential" else
                     default_runner())
    # the checkpoint was pulled into the empty staging directory and served
    staged = tmp_path / "weights" / EMBED_ID / "params.msgpack"
    assert staged.read_bytes() == storage_client.read_bytes(f"{WEIGHTS}/{EMBED_ID}/params.msgpack")
    assert _counts(summary) == _counts(j_summary)
    assert summary["num_videos"] == 2 and summary["num_clips"] == summary["num_with_embeddings"] == 5
    assert summary["weights_provenance"][EMBED_ID].startswith("checkpoint:")
    files = _remote_files(out)
    assert json.loads(files["summary.json"]) == summary
    _assert_split_outputs_match(files, _remote_files(j_out))

    # resume: the output on az:// records every video done
    assert discover_split_tasks(INPUT, out) == []
    again = _split("port", out, tmp_path / "weights")
    assert again["num_videos"] == 0 and again["num_clips"] == 0


def _csv_set(data: bytes) -> set[tuple]:
    return {tuple(row.values()) for row in csv.DictReader(io.StringIO(data.decode()))}


def _tar_members(data: bytes) -> dict[str, bytes]:
    with tarfile.open(fileobj=io.BytesIO(data)) as tar:
        return {m.name: tar.extractfile(m).read() for m in tar.getmembers()}


def test_remote_dedup_and_shard_match_jax(stores, jax_remote, tmp_path, monkeypatch):
    """``run_dedup`` and ``run_shard`` from the ``az://`` split outputs to
    ``gs://`` in both packages: the same dedup rows, the same shards."""
    j_split, _ = jax_remote
    split_out = "az://out/port-chain"
    _split("port", split_out, tmp_path / "weights")
    picks = record_jax_picks(monkeypatch)
    kw = dict(eps=0.07)
    want = jdedup.run_dedup(jdedup.DedupPipelineArgs(input_path=j_split, output_path="gs://bkt/dedup-jax", **kw))
    _, x, _ = tdedup.load_embeddings(split_out)
    port_first_from(monkeypatch, picks, x)
    got = tdedup.run_dedup(tdedup.DedupPipelineArgs(input_path=split_out, output_path="gs://bkt/dedup-port",
                                                    device="cpu", **kw))
    assert got.pop("elapsed_s") >= 0 and want.pop("elapsed_s") >= 0
    assert got == want and got["num_embeddings"] == 5
    name = "dedup_summary_0.07.csv"
    rows = _csv_set(storage_client.read_bytes(f"gs://bkt/dedup-port/{name}"))
    assert rows == _csv_set(storage_client.read_bytes(f"gs://bkt/dedup-jax/{name}")) and len(rows) == 5

    runs = {}
    for pkg, shard, src in (("jax", jshard, j_split), ("port", tshard, split_out)):
        runs[pkg] = shard.run_shard(shard.ShardPipelineArgs(input_path=src, output_path=f"gs://bkt/shard-{pkg}",
                                                            dedup_csv=f"gs://bkt/dedup-{pkg}/{name}"))
    assert runs["port"]["num_samples"] == runs["jax"]["num_samples"] == got["num_kept"]
    shards = {rel: _tar_members(d) for rel, d in _remote_files("gs://bkt/shard-port").items() if rel.endswith(".tar")}
    j_shards = {rel: _tar_members(d) for rel, d in _remote_files("gs://bkt/shard-jax").items() if rel.endswith(".tar")}
    assert shards and shards.keys() == j_shards.keys()
    for rel, members in j_shards.items():
        assert shards[rel].keys() == members.keys(), rel
        for m, data in members.items():
            if m.endswith(".npy"):
                np.testing.assert_allclose(np.load(io.BytesIO(shards[rel][m])), np.load(io.BytesIO(data)),
                                           atol=ATOL, rtol=RTOL, err_msg=m)
            else:
                assert shards[rel][m] == data, m


def test_local_split_cli_reads_s3_and_writes_gs(stores, tmp_path):
    """``local split`` as a subprocess: it reaches the fakes through the
    environment it inherits. Its clips are the in-process run's (by uuid
    and file name; the subprocess may pick another codec)."""
    out = "gs://bkt/cli-split"
    env = {k: v for k, v in __import__("os").environ.items()}
    env[tregistry.WEIGHTS_DIR_ENV] = str(tmp_path / "cli_weights")
    argv = [sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", "local", "split", "--input-path", INPUT,
            "--output-path", out, "--fixed-stride-len-s", "1.0", "--min-clip-len-s", "0.5", "--sequential",
            "--device", "cpu"]
    proc = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=300,
                          cwd=str(Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr[-3000:]
    local_out = tmp_path / "local"
    tsplit.run_split(tsplit.SplitPipelineArgs(input_path=INPUT, output_path=str(local_out), fixed_stride_len_s=1.0,
                                              min_clip_len_s=0.5, device="cpu"), runner=SequentialRunner())
    files = _remote_files(out)
    local = {str(p.relative_to(local_out)) for p in local_out.rglob("*") if p.is_file()}
    assert set(files) == local - {"report/live/status.json"}
    assert sum(rel.startswith("clips/") for rel in files) == 5
    summary = json.loads(files["summary.json"])
    assert summary["num_videos"] == 2 and summary["num_clips"] == summary["num_transcoded"] == 5


def _storage_read_spans(root: str) -> list[dict]:
    files = _remote_files(root)
    spans = [json.loads(line) for rel, data in files.items() if rel.startswith("profile/traces/")
             and rel.endswith(".ndjson") for line in data.decode().splitlines()]
    return [s for s in spans if s["name"] == "storage.read"]


def test_traced_remote_split_records_the_retries(stores, tmp_path):
    """Two HTTP 503s on the fake S3, armed once discovery has listed the
    input: the traced run succeeds in both packages, and the retried
    download's ``storage.read`` span carries the attempt count and the
    backoff, with the same attributes in both."""
    spans = {}
    for package, split in (("jax", jsplit), ("port", tsplit)):
        out = f"az://out/traced-{package}"
        mp = pytest.MonkeyPatch()
        mp.setenv(tregistry.WEIGHTS_DIR_ENV, str(tmp_path / package))
        discover = split.discover_split_tasks

        def discover_then_fail(*a, _discover=discover, **kw):
            tasks = _discover(*a, **kw)
            stores.s3.state.fail_next = 2
            return tasks

        mp.setattr(split, "discover_split_tasks", discover_then_fail)
        try:
            with preserved_observability_state():
                kw = dict(fixed_stride_len_s=1.0, min_clip_len_s=0.5, tracing=True, input_path=INPUT,
                          output_path=out)
                if package == "port":
                    kw["device"] = "cpu"
                summary = split.run_split(split.SplitPipelineArgs(**kw),
                                          runner=JSequentialRunner() if package == "jax" else SequentialRunner())
        finally:
            mp.undo()
        assert stores.s3.state.fail_next == 0 and summary["num_clips"] == 5 and summary["num_errors"] == 0
        spans[package] = _storage_read_spans(out)
    for package, reads in spans.items():
        retried = [s for s in reads if s["attributes"].get("attempt")]
        assert len(retried) == 1 and retried[0]["attributes"]["attempt"] == 3, package
        assert retried[0]["attributes"]["backend"] == "s3" and retried[0]["attributes"]["backoff_s"] >= 0
    assert sorted(spans["port"][0]["attributes"]) == sorted(spans["jax"][0]["attributes"])
    assert {s["attributes"]["path"] for s in spans["port"]} == {s["attributes"]["path"] for s in spans["jax"]}


def test_streaming_remote_split_matches_jax(stores, monkeypatch):
    """``CURATE_RUNNER=streaming`` in both packages from ``s3://`` to
    ``az://``: the CPU stages run in spawned workers, which reach the fakes
    through the environment they inherit (no client crosses a process).
    The workers probe their own codec, so clips compare by name and metas
    in full."""
    monkeypatch.setenv("CURATE_RUNNER", "streaming")
    kw = dict(input_path=INPUT, fixed_stride_len_s=1.0, min_clip_len_s=0.5)
    summary = tsplit.run_split(tsplit.SplitPipelineArgs(output_path="az://out/stream-port", device="cpu", **kw))
    with preserved_observability_state():
        j_summary = jsplit.run_split(jsplit.SplitPipelineArgs(output_path="az://out/stream-jax", **kw))
    assert _counts(summary) == _counts(j_summary) and summary["num_clips"] == summary["num_transcoded"] == 5
    files, j_files = _remote_files("az://out/stream-port"), _remote_files("az://out/stream-jax")
    assert set(files) == set(j_files) and sum(f.startswith("clips/") for f in files) == 5
    for rel, data in j_files.items():
        if rel.startswith("metas/"):
            assert json.loads(files[rel]) == json.loads(data), rel
