"""Port parity: dimension buckets, webdataset shards and the shard pipeline,
then the dedup -> shard chain as a whole.

Tar files are not compared byte for byte: ``ShardWriter`` stamps each
member with the time of writing. What must match exactly: the buckets,
the shard paths (relative to the output), each shard's member names in
order, each member's bytes, and ``index.json`` apart from ``elapsed_s``.
"""

import dataclasses
import io
import json
import tarfile
from pathlib import Path

import numpy as np
import pytest

from cosmos_curate_tpu.dataset import dimensions as jdim
from cosmos_curate_tpu.dataset import webdataset as jwds
from cosmos_curate_tpu.pipelines.video import dedup as jdedup
from cosmos_curate_tpu.pipelines.video import shard as jshard
from cosmos_curate_tpu_torch.dataset import dimensions as tdim
from cosmos_curate_tpu_torch.dataset import webdataset as twds
from cosmos_curate_tpu_torch.pipelines.video import dedup as tdedup
from cosmos_curate_tpu_torch.pipelines.video import shard as tshard
from tests.fixtures.media import make_scene_video
from tests.test_torch_dedup import planted, port_first_from, record_jax_picks, write_split_embeddings

WIDTHS = [0, 90, 320, 480, 640, 1280, 1920, 3840]
HEIGHTS = [0, 64, 360, 480, 720, 1080, 2160]
FRAMES = [0, 15, 16, 64, 200, 256, 1000]


@pytest.mark.parametrize("duration", [None, 0.5, 2.0, 7.5, 45.0, 120.0])
def test_bucket_for_matches_jax_over_a_grid(duration):
    for w in WIDTHS:
        for h in HEIGHTS:
            for f in FRAMES:
                got = tdim.bucket_for(w, h, f, duration_s=duration)
                want = jdim.bucket_for(w, h, f, duration_s=duration)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (w, h, f)
                assert (got.key, got.path) == (want.key, want.path)
                assert dataclasses.asdict(tdim.DimensionBucket.from_path(got.path)) == dataclasses.asdict(got)


def test_dimension_helpers_match_jax():
    for n in (0, 1, 2, 3, 5.5, 7, 100.9, 101):
        assert tdim.round_to_even(n) == jdim.round_to_even(n)
    for w, h in ((1920, 1080), (1080, 1920), (640, 480), (101, 77)):
        got = tdim.Dimensions(w, h).resize_by_shortest_side(224)
        assert dataclasses.asdict(got) == dataclasses.asdict(jdim.Dimensions(w, h).resize_by_shortest_side(224))
    with pytest.raises(ValueError):
        tdim.Dimensions(4, 4).resize_by_shortest_side(3)
    with pytest.raises(ValueError):
        tdim.RangeBins([0, 1, 1], ["a", "b"])
    with pytest.raises(ValueError):
        tdim.DimensionBucket.from_path("not/a/bucket")


def _members(path) -> list[tuple[str, bytes]]:
    with tarfile.open(fileobj=io.BytesIO(Path(path).read_bytes())) as tar:
        return [(m.name, tar.extractfile(m).read()) for m in tar.getmembers()]


def _samples(seed: int, n: int) -> list[tuple[str, dict]]:
    rng = np.random.default_rng(seed)
    return [(f"s{i:03d}", dict(mp4=rng.bytes(int(rng.integers(100, 3000))), meta={"uuid": f"s{i:03d}", "i": i},
                               arrays={"embedding": rng.standard_normal(8).astype(np.float32)},
                               text=None if i % 2 else f"caption {i}"))
            for i in range(n)]


@pytest.mark.parametrize("max_samples,max_bytes", [(4, 1 << 30), (512, 6000), (3, 9000)],
                         ids=["sample-cap", "byte-cap", "both"])
def test_shard_writer_caps_match_jax(max_samples, max_bytes, tmp_path):
    writers = {name: mod.ShardWriter(str(tmp_path / name), max_samples_per_shard=max_samples,
                                     max_bytes_per_shard=max_bytes)
               for name, mod in (("jax", jwds), ("port", twds))}
    for key, parts in _samples(0, 11):
        writers["jax"].add_sample(key, jwds.encode_sample_parts(**parts))
        writers["port"].add_sample(key, twds.encode_sample_parts(**parts))
    paths = {name: w.close() for name, w in writers.items()}
    assert [Path(p).relative_to(tmp_path / "port") for p in paths["port"]] == [
        Path(p).relative_to(tmp_path / "jax") for p in paths["jax"]]
    assert len(paths["port"]) > 1
    for p, j in zip(paths["port"], paths["jax"], strict=True):
        assert _members(p) == _members(j)
        assert [key for key, _ in twds.iter_tar_samples(Path(p).read_bytes())] == [
            key for key, _ in jwds.iter_tar_samples(Path(j).read_bytes())]
        n = len(list(twds.iter_tar_samples(Path(p).read_bytes())))
        assert n <= max_samples


def test_shard_args_mirror_the_reference_field_for_field():
    assert [(f.name, f.default) for f in dataclasses.fields(tshard.ShardPipelineArgs)] == [
        (f.name, f.default) for f in dataclasses.fields(jshard.ShardPipelineArgs)]


# clips of three sizes (two buckets) and frame counts, one without an mp4,
# one without an embedding; captions in two variants
CLIPS = [
    ("a0", (96, 64), 20, {"default": "a red scene"}),
    ("a1", (96, 64), 40, {"other": "only another variant"}),
    ("b0", (64, 96), 18, {}),
    ("b1", (64, 96), 70, {"default": "", "x": "falls through"}),
    ("c0", (128, 72), 24, {"default": "wide"}),
    ("missing", (96, 64), 20, {"default": "no mp4 on disk"}),
]


@pytest.fixture(scope="module")
def split_output(tmp_path_factory) -> tuple[Path, list[str], np.ndarray]:
    """A split output's layout: clips/, metas/v0/ and embeddings/ (every
    clip but c0 embedded; duplicates planted among the embeddings)."""
    root = tmp_path_factory.mktemp("split_out")
    (root / "clips").mkdir()
    (root / "metas" / "v0").mkdir(parents=True)
    for uuid, size, frames, caps in CLIPS:
        if uuid != "missing":
            make_scene_video(root / "clips" / f"{uuid}.mp4", scene_len_frames=frames, num_scenes=1, size_wh=size)
        meta = {"uuid": uuid, "source_video": "v.mp4", "windows": [{"start_frame": 0, "end_frame": frames,
                                                                  "captions": caps}]}
        (root / "metas" / "v0" / f"{uuid}.json").write_text(json.dumps(meta))
    x, _ = planted(8, 2, 3, 16, dup_every=2)
    ids = ["a0", "a1", "b0", "b1", "missing", "extra"]
    write_split_embeddings(root, x, ids, chunks=2, other=False)
    return root, ids, x


def _shard_files(out: Path) -> dict[str, list[tuple[str, bytes]]]:
    return {str(p.relative_to(out)): _members(p) for p in sorted(out.rglob("*.tar"))}


def _index(out: Path, summary: dict) -> dict:
    index = json.loads((out / "index.json").read_text())
    assert index.pop("elapsed_s") >= 0 and summary.pop("elapsed_s") >= 0
    for bucket in index["buckets"].values():
        bucket["shards"] = [str(Path(p).relative_to(out)) for p in bucket["shards"]]
    return index


@pytest.mark.parametrize("kept,embeddings,max_samples", [
    (None, True, 512), (("a0", "b1", "c0", "missing"), True, 1), (None, False, 2)],
    ids=["all", "dedup-csv", "no-embeddings"])
def test_run_shard_matches_jax(kept, embeddings, max_samples, split_output, tmp_path):
    root = split_output[0]
    csv_path = ""
    if kept is not None:
        csv_path = str(tmp_path / "dedup.csv")
        rows = ["clip_uuid,action,duplicate_of"] + [
            f"{u},{'kept' if u in kept else 'removed'},{'' if u in kept else 'a0'}" for u, *_ in CLIPS]
        Path(csv_path).write_text("\n".join(rows) + "\n")
    kw = dict(input_path=str(root), dedup_csv=csv_path, include_embeddings=embeddings,
              max_samples_per_shard=max_samples)
    want = jshard.run_shard(jshard.ShardPipelineArgs(output_path=str(tmp_path / "jax"), **kw))
    got = tshard.run_shard(tshard.ShardPipelineArgs(output_path=str(tmp_path / "port"), **kw))
    assert _index(tmp_path / "port", got) == _index(tmp_path / "jax", want)
    assert got == {**want, "buckets": got["buckets"]}
    shards = _shard_files(tmp_path / "port")
    assert shards == _shard_files(tmp_path / "jax")
    members = [name for tar in shards.values() for name, _ in tar]
    expect = [u for u, *_ in CLIPS if u != "missing" and (kept is None or u in kept)]
    assert sorted({m.split(".", 1)[0] for m in members}) == sorted(expect)
    assert got["num_samples"] == len(expect)
    assert got["num_buckets"] == len({Path(p).parent for p in shards}) > 1
    assert any(m.endswith(".embedding.npy") for m in members) == embeddings


def test_dedup_then_shard_matches_jax(split_output, tmp_path, monkeypatch):
    """The chain as users run it: run_dedup on the split output, then
    run_shard with its CSV, in each package (the port given the JAX
    seeding's first row)."""
    root, ids, x = split_output
    picks = record_jax_picks(monkeypatch)
    kw = dict(input_path=str(root), eps=0.07)
    j_dedup = jdedup.run_dedup(jdedup.DedupPipelineArgs(output_path=str(tmp_path / "jax_dedup"), **kw))
    port_first_from(monkeypatch, picks, x)
    t_dedup = tdedup.run_dedup(tdedup.DedupPipelineArgs(output_path=str(tmp_path / "port_dedup"), device="cpu",
                                                        **kw))
    assert t_dedup.pop("elapsed_s") >= 0 and j_dedup.pop("elapsed_s") >= 0
    assert t_dedup == j_dedup and t_dedup["num_removed"] > 0
    runs = {}
    for name, shard in (("jax", jshard), ("port", tshard)):
        csv_path = tmp_path / f"{name}_dedup" / "dedup_summary_0.07.csv"
        runs[name] = shard.run_shard(shard.ShardPipelineArgs(input_path=str(root), output_path=str(tmp_path / name),
                                                             dedup_csv=str(csv_path)))
    assert _index(tmp_path / "port", runs["port"]) == _index(tmp_path / "jax", runs["jax"])
    shards = _shard_files(tmp_path / "port")
    assert shards == _shard_files(tmp_path / "jax")
    kept_rows = [line.split(",")[0] for line in (tmp_path / "port_dedup" / "dedup_summary_0.07.csv").read_text()
                 .splitlines()[1:] if line.split(",")[1] == "kept"]
    members = {name.split(".", 1)[0] for tar in shards.values() for name, _ in tar}
    # every kept clip with an mp4 is sharded; clips without an embedding
    # (c0) are not in the dedup run and so are skipped with the removed
    assert members == {u for u in kept_rows if u != "missing" and (root / "clips" / f"{u}.mp4").exists()}
    assert runs["port"]["num_skipped_by_dedup"] == runs["jax"]["num_skipped_by_dedup"] > 0
    # the sharded bytes are the clip's mp4, its meta and its embedding
    for tar in shards.values():
        for name, data in tar:
            uuid, ext = name.split(".", 1)
            if ext == "mp4":
                assert data == (root / "clips" / f"{uuid}.mp4").read_bytes()
            elif ext == "json":
                assert json.loads(data) == json.loads((root / "metas" / "v0" / f"{uuid}.json").read_text())
            elif ext == "embedding.npy":
                np.testing.assert_array_equal(np.load(io.BytesIO(data)), x[ids.index(uuid)])
