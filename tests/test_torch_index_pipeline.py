"""Port parity: the corpus index in the pipelines: the writer's pending
fragments, ``IncrementalDedupStage``, ``run_split(corpus_index=True)`` and
``run_split(incremental_dedup=...)``, and ``run_dedup``'s index path.

Each case runs the JAX package and the port on the same inputs on the CPU.
The stage and ``run_dedup`` cases query one index (JAX-written) from both
packages and must agree exactly: the same removed clips, ``filtered_by``,
``duplicate_of``, counts, CSV rows and summaries. The two ``run_split``
runs embed with the tiny video embedder from one staged checkpoint (so the
weights' provenance is a checkpoint and the index gates pass) and the
port's k-means is given the JAX run's first pick; the embeddings agree
within the split tests' bf16 bound, so the index's contents and the
duplicates found must match, and its centroids agree within that bound.
"""

import csv
import json
import sys
import uuid

import numpy as np
import pytest

from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.dedup import corpus_index as jci
from cosmos_curate_tpu.dedup import kmeans as jk
from cosmos_curate_tpu.models import embedder as jemb
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.pipelines.video import dedup as jdedup
from cosmos_curate_tpu.pipelines.video import split as jsplit
from cosmos_curate_tpu.pipelines.video.stages import dedup_stage as jstage
from cosmos_curate_tpu.pipelines.video.stages import writer as jwriter
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.dedup import corpus_index as tci
from cosmos_curate_tpu_torch.dedup import index_store as tstore
from cosmos_curate_tpu_torch.dedup import kmeans as tk
from cosmos_curate_tpu_torch.models import embedder as temb
from cosmos_curate_tpu_torch.models import registry as tregistry
from cosmos_curate_tpu_torch.pipelines.video import dedup as tdedup
from cosmos_curate_tpu_torch.pipelines.video import split as tsplit
from cosmos_curate_tpu_torch.pipelines.video.stages import dedup_stage as tstage
from cosmos_curate_tpu_torch.pipelines.video.stages import writer as twriter
from tests.fixtures.media import make_scene_video
from tests.fixtures.observability import observability_state  # noqa: F401  (autouse)
from tests.test_torch_dedup import record_jax_picks, write_split_embeddings

MODEL = "video-embed-tpu"
EMBED_TOL = 2e-2  # the split tests' bound on the tiny embedder's bf16 embeddings
DIM = 16
CKPT = "checkpoint:feedc0ffee12"


def tasks(data, vecs, *, path: str = "vid.mp4", seed: int = 0):
    """One task per package module ``data``, its clips holding ``vecs``
    under ``MODEL``, with uuids drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    video = data.Video(path=path)
    for v in np.asarray(vecs, np.float32):
        video.clips.append(data.Clip(uuid=uuid.UUID(bytes=rng.bytes(16), version=4), embeddings={MODEL: v.copy()}))
    return [data.SplitPipeTask(video=video)]


@pytest.fixture
def checkpoint_provenance(monkeypatch):
    monkeypatch.setattr(jregistry, "weights_provenance", lambda model_id: CKPT)
    monkeypatch.setattr(tregistry, "weights_provenance", lambda model_id: CKPT)
    monkeypatch.setattr(twriter, "weights_provenance", lambda model_id: CKPT)


# -- the writer's fragments -------------------------------------------------------


@pytest.mark.parametrize("provenance", ["checkpoint", "random", "random_allowed"])
def test_writer_fragments_match_the_reference(provenance, tmp_path, monkeypatch, request):
    """The same chunk through both writers with ``index_path``: the same
    pending fragment bytes (embeddings, model, provenance), the same
    ``stage_perf`` counts, and random-provenance rows refused unless
    allowed; the embeddings parquet is written either way."""
    monkeypatch.delenv(tstore.ALLOW_RANDOM_ENV, raising=False)
    if provenance == "checkpoint":
        request.getfixturevalue("checkpoint_provenance")
    elif provenance == "random_allowed":
        monkeypatch.setenv(tstore.ALLOW_RANDOM_ENV, "1")
    vecs = np.random.default_rng(1).standard_normal((3, DIM))
    out = {}
    for name, stage_cls, data in (("j", jwriter.ClipWriterStage, jdata), ("t", twriter.ClipWriterStage, tdata)):
        stage = stage_cls(str(tmp_path / name / "out"), index_path=str(tmp_path / name / "index"))
        out[name] = stage.process_data(tasks(data, vecs))[0]
    t_perf = {k: v for k, v in out["t"].stage_perf.items() if k.startswith("index_")}
    assert t_perf == {k: v for k, v in out["j"].stage_perf.items() if k.startswith("index_")}
    pending = sorted((tmp_path / "t" / "index" / "pending").glob("*.parquet"))
    if provenance == "random":
        assert pending == [] and t_perf == {"index_skipped_random": 3}
    else:
        assert t_perf == {"index_fragment_rows": 3} and len(pending) == 1
        assert pending[0].read_bytes() == (tmp_path / "j" / "index" / "pending" / pending[0].name).read_bytes()
        _ids, got, models, provs = tstore.IndexStore(str(tmp_path / "t" / "index")).read_pending()
        np.testing.assert_array_equal(got, tstore.normalize_rows(vecs))
        assert models == [MODEL] * 3 and provs == ([CKPT] if provenance == "checkpoint" else ["random"]) * 3
    assert list((tmp_path / "t" / "out" / "embeddings" / MODEL).glob("*.parquet"))


def test_no_index_path_writes_no_fragments(tmp_path, checkpoint_provenance):
    task = twriter.ClipWriterStage(str(tmp_path / "out")).process_data(tasks(tdata, np.ones((2, DIM))))[0]
    assert not (tmp_path / "out" / "index").exists()
    assert not any(k.startswith("index_") for k in task.stage_perf)


# -- IncrementalDedupStage --------------------------------------------------------


@pytest.fixture
def corpus_index(tmp_path):
    """A 40-row index written by the JAX package."""
    base = np.random.default_rng(2).standard_normal((40, DIM)).astype(np.float32)
    root = str(tmp_path / "index")
    jci.CorpusIndex.build(root, [f"corpus{i}" for i in range(40)], base, model=MODEL, k=4)
    return root, base


def stage_batch(base):
    rng = np.random.default_rng(3)
    novel = rng.standard_normal((2, DIM)).astype(np.float32) * 2
    return np.concatenate([base[[7]] + 1e-6, novel[:1], base[[3]] + 1e-6, novel[1:], novel[:1] + 1e-6])


def run_stages(root, vecs, **kw):
    out = {}
    for name, cls, data, extra in (("j", jstage.IncrementalDedupStage, jdata, {}),
                                   ("t", tstage.IncrementalDedupStage, tdata, {"device": "cpu"})):
        stage = cls(root, **kw, **extra)
        stage.setup(None)
        out[name] = stage.process_data(tasks(data, vecs))[0]
    return out["j"], out["t"]


def clip_view(task):
    video = task.video
    return ([(str(c.uuid), c.filtered_by, c.duplicate_of) for c in video.clips],
            [(str(c.uuid), c.filtered_by, c.duplicate_of) for c in video.filtered_clips], dict(task.stage_perf))


@pytest.mark.parametrize("mode", ["enable", "score-only"])
@pytest.mark.parametrize("eps", [1e-3, 0.07])
def test_stage_matches_the_reference(mode, eps, corpus_index, checkpoint_provenance):
    root, base = corpus_index
    j_task, t_task = run_stages(root, stage_batch(base), eps=eps, score_only=mode == "score-only")
    assert clip_view(t_task) == clip_view(j_task)
    kept, filtered, perf = clip_view(t_task)
    assert perf["dedup_duplicates"] == 3  # two indexed copies and the batch-internal copy
    if mode == "enable":
        assert [f[1] for f in filtered] == ["dedup"] * 3 and len(kept) == 2
        assert [f[2] for f in filtered][:2] == ["corpus7", "corpus3"]
        assert filtered[2][2] == kept[0][0]  # the batch-internal copy points at the kept original
    else:
        assert filtered == [] and len(kept) == 5 and all(k[1] == "" for k in kept)
        assert [k[2] for k in kept][:3] == ["corpus7", "", "corpus3"]


def test_stage_refuses_random_provenance(corpus_index, monkeypatch):
    monkeypatch.delenv(tstore.ALLOW_RANDOM_ENV, raising=False)
    root, base = corpus_index
    j_task, t_task = run_stages(root, base[[0]] + 1e-6, eps=1e-3)
    assert clip_view(t_task) == clip_view(j_task)
    assert len(t_task.video.clips) == 1 and not t_task.video.filtered_clips
    monkeypatch.setenv(tstore.ALLOW_RANDOM_ENV, "1")
    j_task, t_task = run_stages(root, base[[0]] + 1e-6, eps=1e-3)
    assert clip_view(t_task) == clip_view(j_task) and len(t_task.video.filtered_clips) == 1


def test_stage_passes_everything_through_without_an_index(tmp_path, checkpoint_provenance):
    stage = tstage.IncrementalDedupStage(str(tmp_path / "absent"), device="cpu")
    stage.setup(None)
    batch = tasks(tdata, np.ones((2, DIM)))
    assert stage.process_data(batch) == batch and len(batch[0].video.clips) == 2
    assert stage.resources.cpus == jstage.IncrementalDedupStage("x").resources.cpus == 1.0
    assert not stage.resources.uses_gpu


def test_writer_counts_and_writes_the_dedup_filtered(corpus_index, tmp_path, checkpoint_provenance):
    root, base = corpus_index
    j_task, t_task = run_stages(root, stage_batch(base), eps=1e-3)
    for name, writer_cls, task in (("j", jwriter.ClipWriterStage, j_task), ("t", twriter.ClipWriterStage, t_task)):
        writer_cls(str(tmp_path / name)).process_data([task])
    assert t_task.stats.num_filtered_by_dedup == j_task.stats.num_filtered_by_dedup == 3
    metas = {p.name: json.loads(p.read_text()) for p in (tmp_path / "t" / "metas" / "filtered").glob("*.json")}
    j_metas = {p.name: json.loads(p.read_text()) for p in (tmp_path / "j" / "metas" / "filtered").glob("*.json")}
    assert metas == j_metas and len(metas) == 3
    assert {m["duplicate_of"] for m in metas.values()} >= {"corpus7", "corpus3"}


# -- run_split: build the index, then drop every duplicate ------------------------


SPLIT_KW = dict(fixed_stride_len_s=1.0, min_clip_len_s=0.5, extract_fps=(4.0,), extract_resize_hw=(32, 32),
                embedding_model="video")


@pytest.fixture(scope="module")
def split_weights(tmp_path_factory):
    """The tiny video embedder's seeded init, staged under the real id by
    the JAX registry: both packages load it, and its provenance is a
    checkpoint."""
    root = tmp_path_factory.mktemp("index_weights")
    embedder = jemb.VideoEmbedder(jemb.VIDEO_EMBED_TINY_TEST)
    embedder.setup()
    jregistry.save_params(MODEL, embedder._params, root=root)
    return root


@pytest.fixture(scope="module")
def split_videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("index_videos")
    (d / "in1").mkdir()
    (d / "in2").mkdir()
    make_scene_video(d / "in1" / "v0.mp4", scene_len_frames=24, num_scenes=2)
    make_scene_video(d / "in1" / "v1.mp4", scene_len_frames=24, num_scenes=2, moving_box=False)
    make_scene_video(d / "in2" / "v0_again.mp4", scene_len_frames=24, num_scenes=2)  # v0's content, new uuids
    return d


def record_jax_pick_rows(monkeypatch) -> list[int]:
    """The row index each JAX k-means seeding starts from (its data are
    padded rows under the test mesh; the pick is found among them)."""
    rows: list[int] = []
    init = jk._init_centroids

    def recording(data, k, seed, valid):
        cents = init(data, k, seed, valid)
        rows.append(int(np.argmin(np.abs(np.asarray(data)[:valid] - np.asarray(cents)[0]).sum(1))))
        return cents

    monkeypatch.setattr(jk, "_init_centroids", recording)
    return rows


@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_two_split_runs_build_then_query_the_index(runner, split_videos, split_weights, tmp_path, monkeypatch):
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(split_weights))
    monkeypatch.delenv(tstore.ALLOW_RANDOM_ENV, raising=False)
    monkeypatch.setitem(jemb.VIDEO_EMBED_VARIANTS, "video", (jemb.VIDEO_EMBED_TINY_TEST, MODEL))
    monkeypatch.setitem(temb.VIDEO_EMBED_VARIANTS, "video", (temb.VIDEO_EMBED_TINY_TEST, MODEL))
    rows = record_jax_pick_rows(monkeypatch)
    first = dict(input_path=str(split_videos / "in1"), corpus_index=True, **SPLIT_KW)
    j1 = jsplit.run_split(jsplit.SplitPipelineArgs(output_path=str(tmp_path / "j1"), **first),
                          runner=JSequentialRunner())
    monkeypatch.setattr(tk, "_first_index", lambda valid, seed: rows[-1])
    run = SequentialRunner() if runner == "sequential" else None
    t1 = tsplit.run_split(tsplit.SplitPipelineArgs(output_path=str(tmp_path / "t1"), device="cpu", **first),
                          runner=run)
    assert t1["corpus_index"] == {**j1["corpus_index"], "path": str(tmp_path / "t1" / "index")}
    assert t1["corpus_index"]["consolidated"] == t1["num_with_embeddings"] == 4
    assert t1["corpus_index"]["skipped_random"] == 0
    t_index, j_index = tci.CorpusIndex.open(str(tmp_path / "t1" / "index"), device="cpu"), jci.CorpusIndex.open(
        str(tmp_path / "j1" / "index"))
    assert t_index.meta == j_index.meta and t_index.meta["num_vectors"] == 4 and t_index.meta["model"] == MODEL
    assert t_index.store.list_pending() == []
    np.testing.assert_allclose(t_index.centroids, j_index.centroids, atol=EMBED_TOL)
    for cid in range(t_index.meta["k"]):
        assert t_index.store.read_cluster(cid)[0] == j_index.store.read_cluster(cid)[0]

    second = dict(input_path=str(split_videos / "in2"), incremental_dedup="enable", dedup_eps=1e-3, **SPLIT_KW)
    j2 = jsplit.run_split(jsplit.SplitPipelineArgs(output_path=str(tmp_path / "j2"),
                                                   index_path=str(tmp_path / "j1" / "index"), **second),
                          runner=JSequentialRunner())
    t2 = tsplit.run_split(tsplit.SplitPipelineArgs(output_path=str(tmp_path / "t2"), device="cpu",
                                                   index_path=str(tmp_path / "t1" / "index"), **second), runner=run)
    keys = ("num_clips", "num_filtered_by_dedup", "num_with_embeddings", "num_transcoded")
    assert {k: t2[k] for k in keys} == {k: j2[k] for k in keys}
    assert t2["num_filtered_by_dedup"] == t2["num_clips"] == 2 and t2["num_with_embeddings"] == 0
    assert "corpus_index" not in t2 and not (tmp_path / "t2" / "embeddings").exists()
    metas = [json.loads(p.read_text()) for p in sorted((tmp_path / "t2" / "metas" / "filtered").glob("*.json"))]
    j_metas = [json.loads(p.read_text()) for p in sorted((tmp_path / "j2" / "metas" / "filtered").glob("*.json"))]
    assert [(m["uuid"], m["filtered_by"], m["duplicate_of"]) for m in metas] == [
        (m["uuid"], m["filtered_by"], m["duplicate_of"]) for m in j_metas]
    assert all(m["filtered_by"] == "dedup" and m["duplicate_of"] for m in metas)
    # the index is untouched by the second run
    assert tci.CorpusIndex.open(str(tmp_path / "t1" / "index"), device="cpu").meta["num_vectors"] == 4


def test_incremental_dedup_needs_an_embedding_model(tmp_path):
    args = tsplit.SplitPipelineArgs(input_path=str(tmp_path), output_path=str(tmp_path / "out"),
                                    incremental_dedup="enable", device="cpu")
    with pytest.raises(ValueError, match="needs an --embedding-model"):
        tsplit.run_split(args)
    with pytest.raises(ValueError, match="needs an --embedding-model"):
        jsplit.assemble_stages(jsplit.SplitPipelineArgs(output_path=str(tmp_path / "out"),
                                                        incremental_dedup="enable"))


@pytest.mark.parametrize("opts", [dict(corpus_index=True), dict(corpus_index=True, index_path="/elsewhere/idx/"),
                                  dict(incremental_dedup="score-only", dedup_eps=0.2, dedup_nprobe=3)])
def test_index_options_assemble_as_the_reference(opts, tmp_path):
    kw = dict(output_path=str(tmp_path / "out"), embedding_model="video", **opts)
    j_stages = jsplit.assemble_stages(jsplit.SplitPipelineArgs(**kw))
    t_stages = tsplit.assemble_stages(tsplit.SplitPipelineArgs(device="cpu", **kw))
    assert [type(s).__name__ for s in t_stages] == [type(s).__name__ for s in j_stages]
    assert tsplit.resolve_index_path(tsplit.SplitPipelineArgs(**kw)) == jsplit.resolve_index_path(
        jsplit.SplitPipelineArgs(**kw))
    assert t_stages[-1].index_path == j_stages[-1].index_path
    if "incremental_dedup" in opts:
        t_dedup, j_dedup = t_stages[-2], j_stages[-2]
        assert (t_dedup.index_path, t_dedup.eps, t_dedup.nprobe, t_dedup.score_only) == (
            j_dedup.index_path, j_dedup.eps, j_dedup.nprobe, j_dedup.score_only)


@pytest.mark.parametrize("fault", ["storage", "device"])
def test_a_failed_consolidation_is_contained_but_a_device_fault_is_not(fault, tmp_path, monkeypatch):
    from cosmos_curate_tpu_torch.ops._build import KernelError

    def broken(root, **kw):
        raise (OSError("disk full") if fault == "storage" else KernelError("launch failed"))

    monkeypatch.setattr(tsplit, "consolidate_index", broken)
    args = tsplit.SplitPipelineArgs(input_path=str(tmp_path), output_path=str(tmp_path / "out"), corpus_index=True,
                                    device="cpu")
    if fault == "storage":
        assert tsplit._consolidate_corpus_index(args) == {}
    else:
        with pytest.raises(KernelError):
            tsplit._consolidate_corpus_index(args)


# -- run_dedup's index path ------------------------------------------------------


def dedup_run(tmp_path):
    """A split output of 6 rows (two copies of indexed rows, a fresh row
    and its copy, two more fresh rows) and a JAX-written index at
    ``<input>/index`` of 30 rows."""
    rng = np.random.default_rng(4)
    corpus = rng.standard_normal((30, DIM)).astype(np.float32)
    fresh = rng.standard_normal((3, DIM)).astype(np.float32) * 3
    vecs = np.stack([corpus[9] + 1e-6, fresh[0], corpus[4] + 1e-6, fresh[0] + 1e-6, fresh[1], fresh[2]])
    ids = ["d0", "n0", "d1", "n0-copy", "n1", "n2"]
    write_split_embeddings(tmp_path / "run", vecs, ids, model=MODEL, chunks=2, other=False)
    jci.CorpusIndex.build(str(tmp_path / "run" / "index"), [f"corpus{i}" for i in range(30)], corpus, model=MODEL,
                          k=3)
    return ids, vecs


def csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("where", ["default_root", "index_path"])
def test_run_dedup_queries_the_index_like_the_reference(where, tmp_path, monkeypatch):
    dedup_run(tmp_path)
    kw = dict(input_path=str(tmp_path / "run"), eps=1e-3)
    if where == "index_path":
        (tmp_path / "run" / "index").rename(tmp_path / "elsewhere")
        kw["index_path"] = str(tmp_path / "elsewhere") + "/"
    monkeypatch.setenv(tdedup.FETCH_THREADS_ENV, "2")
    want = jdedup.run_dedup(jdedup.DedupPipelineArgs(output_path=str(tmp_path / "j"), use_mesh=False, **kw))
    got = tdedup.run_dedup(tdedup.DedupPipelineArgs(output_path=str(tmp_path / "t"), device="cpu", **kw))
    assert got.pop("elapsed_s") >= 0 and want.pop("elapsed_s") >= 0
    assert got == want and got["method"] == "index_query"
    assert got["num_removed"] == 3 and got["num_kept"] == 3
    rows = csv_rows(tmp_path / "t" / "dedup_summary_0.001.csv")
    assert rows == csv_rows(tmp_path / "j" / "dedup_summary_0.001.csv")
    assert {r["clip_uuid"]: r["duplicate_of"] for r in rows if r["action"] == "removed"} == {
        "d0": "corpus9", "d1": "corpus4", "n0-copy": "n0"}


@pytest.mark.parametrize("case", ["model_mismatch", "use_index_false", "meta_without_centroids"])
def test_run_dedup_reclusters_like_the_reference(case, tmp_path, monkeypatch):
    ids, vecs = dedup_run(tmp_path)
    root = tmp_path / "run" / "index"
    kw = dict(input_path=str(tmp_path / "run"), eps=1e-3)
    if case == "model_mismatch":
        for p in sorted(root.rglob("*"), reverse=True):
            p.unlink() if p.is_file() else p.rmdir()
        jci.CorpusIndex.build(str(root), ["c0", "c1"], np.ones((2, 32), np.float32), model="clip-vit-b16-tpu", k=1)
    elif case == "use_index_false":
        kw["use_index"] = False
    else:
        (root / "centroids.npy").unlink()
    picks = record_jax_picks(monkeypatch)
    want = jdedup.run_dedup(jdedup.DedupPipelineArgs(output_path=str(tmp_path / "j"), use_mesh=False, **kw))
    data = tk.normalize_rows(vecs)
    monkeypatch.setattr(tk, "_first_index", lambda valid, seed: int(np.argmin(np.abs(data - picks[-1]).sum(1))))
    got = tdedup.run_dedup(tdedup.DedupPipelineArgs(output_path=str(tmp_path / "t"), device="cpu", **kw))
    assert got.pop("elapsed_s") >= 0 and want.pop("elapsed_s") >= 0
    assert got == want and got["method"] == "recluster" and got["index_path"] == ""
    assert csv_rows(tmp_path / "t" / "dedup_summary_0.001.csv") == csv_rows(tmp_path / "j" / "dedup_summary_0.001.csv")


def test_run_dedup_refuses_a_lance_index(tmp_path, monkeypatch):
    """An index whose ``meta.json`` pins lance, on a host without ``lance``:
    both packages refuse the lance backend, fall back to parquet (where the
    fragments are) and query the index alike."""
    monkeypatch.setitem(sys.modules, "lance", None)
    dedup_run(tmp_path)
    meta = json.loads((tmp_path / "run" / "index" / "meta.json").read_text())
    (tmp_path / "run" / "index" / "meta.json").write_text(json.dumps({**meta, "backend": "lance"}))
    kw = dict(input_path=str(tmp_path / "run"), eps=1e-3)
    want = jdedup.run_dedup(jdedup.DedupPipelineArgs(output_path=str(tmp_path / "j"), use_mesh=False, **kw))
    got = tdedup.run_dedup(tdedup.DedupPipelineArgs(output_path=str(tmp_path / "t"), device="cpu", **kw))
    assert got.pop("elapsed_s") >= 0 and want.pop("elapsed_s") >= 0
    assert got == want and got["method"] == "index_query"
    assert csv_rows(tmp_path / "t" / "dedup_summary_0.001.csv") == csv_rows(tmp_path / "j" / "dedup_summary_0.001.csv")
