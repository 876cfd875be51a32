"""Port parity: the index server and compaction (``dedup/index_server.py``,
``dedup/compaction.py``).

The server runs on the CPU here (its scoring products' plain path; the text
tower is the port's seeded ``clip-text-tiny-test``). Its answers are held
against ``CorpusIndex.query`` on the same rows: the same ids in the same
order, similarities within 1e-5. Compaction runs in both packages on two
copies of one index (k-means' rebalance split given the JAX package's first
pick): the same report, manifest, fragments and cluster contents, centroids
within 1e-5. Recall@5 against an exact search must stay >= 0.95 across a
compaction that runs while queries are in flight.
"""

import json
import shutil
import threading

import numpy as np
import pytest

from cosmos_curate_tpu.dedup import compaction as jcomp
from cosmos_curate_tpu.dedup import corpus_index as jci
from cosmos_curate_tpu.dedup import index_store as jstore
from cosmos_curate_tpu_torch.dedup import compaction as tcomp
from cosmos_curate_tpu_torch.dedup import corpus_index as tci
from cosmos_curate_tpu_torch.dedup import index_store as tstore
from cosmos_curate_tpu_torch.dedup.index_server import IndexServer, ProvenanceError
from cosmos_curate_tpu_torch.models.clip_text import CLIPTextEmbeddings
from cosmos_curate_tpu_torch.ops._build import KernelError
from tests.test_torch_corpus_index import assert_hits_equal
from tests.test_torch_dedup import jax_first  # noqa: F401  (fixture)

DIM = 16  # clip-text-tiny-test's projection width
K = 6
ATOL = 1e-5


def corpus(seed: int, *, n_clusters: int = K, per: int = 40, dim: int = DIM, spread: float = 0.05):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    vecs = np.concatenate([c + spread * rng.standard_normal((per, dim)) for c in centres]).astype(np.float32)
    return [f"c{i}" for i in range(len(vecs))], vecs


def built(tmp_path, seed: int = 0, name: str = "idx", **kw):
    ids, vecs = corpus(seed, **kw)
    root = str(tmp_path / name)
    tci.CorpusIndex.build(root, ids, vecs, model="m", k=K, device="cpu")
    return root, ids, vecs


def recall(hits, queries, ids, vecs, k: int = 5) -> float:
    qn, cn = tstore.normalize_rows(queries), tstore.normalize_rows(vecs)
    exact = np.argsort(-(qn @ cn.T), axis=1)[:, :k]
    return sum(len({h for h, _ in hits[i][:k]} & {ids[j] for j in exact[i]}) / k
               for i in range(len(queries))) / len(queries)


def near(rng, vecs, step: int = 5):
    return (vecs[::step] + 0.01 * rng.standard_normal((len(vecs[::step]), vecs.shape[1]))).astype(np.float32)


@pytest.fixture
def server(request):
    servers = []

    def make(*args, **kw):
        srv = IndexServer(*args, device="cpu", **kw)
        servers.append(srv)
        return srv

    yield make
    for srv in servers:
        srv.close()


# -- the server ---------------------------------------------------------------


def test_concurrent_searches_micro_batch_and_match_corpus_index_query(tmp_path, server, jax_first):
    root, ids, vecs = built(tmp_path)
    queries = near(np.random.default_rng(1), vecs)
    srv = server(root, batch_window_s=0.02)
    results = [None] * len(queries)
    barrier = threading.Barrier(len(queries))

    def one(i):
        barrier.wait(timeout=30)
        results[i] = srv.search(queries[i], top_k=5)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert {gen for _hits, gen in results} == {0}
    hits = [r[0][0] for r in results]
    assert_hits_equal(hits, tci.CorpusIndex.open(root, device="cpu").query(queries, top_k=5))
    assert recall(hits, queries, ids, vecs) >= 0.95
    counts = srv.stats()["counts"]
    assert counts["searches"] == counts["queries"] == counts["batched_requests"] == len(queries)
    assert counts["batches"] < len(queries)  # requests shared batches


def test_a_multi_row_request_and_knob_groups(tmp_path, server, jax_first):
    root, _ids, vecs = built(tmp_path)
    srv = server(root)
    index = tci.CorpusIndex.open(root, device="cpu")
    hits, gen = srv.search(vecs[:7] * 2.0, top_k=4, nprobe=2)
    assert gen == 0 and len(hits) == 7
    assert_hits_equal(hits, index.query(vecs[:7], top_k=4, nprobe=2))
    hits, _ = srv.search(vecs[:2], top_k=3, nprobe=-1)  # clamps to one probe
    assert all(len(h) == 3 for h in hits)
    with pytest.raises(ValueError, match="exactly one"):
        srv.search(vecs[0], clip_uuid="c1")
    with pytest.raises(ValueError, match="query dim"):
        srv.search(np.zeros(DIM + 1, np.float32))


def test_warmup_loads_the_largest_clusters(tmp_path, server, jax_first):
    root, _ids, vecs = built(tmp_path)
    srv = server(root)
    stats = srv.stats()
    assert srv.warmed_bytes > 0 and stats["cache"]["resident_shards"] >= 1
    assert stats["cache"]["resident_bytes"] <= stats["cache"]["budget_bytes"]
    assert stats["num_vectors"] == len(vecs) and stats["clusters"] == K and stats["generation"] == 0
    full = server(root, warmup_budget=1 << 30)
    miss = full.cache.stats()["miss_bytes"]
    full.search(vecs[0], top_k=3)  # a warm query touches no storage
    assert full.cache.stats()["miss_bytes"] == miss
    cold = server(root, warmup=False)
    assert cold.warmed_bytes == 0 and cold.cache.stats()["resident_shards"] == 0


def test_uuid_search(tmp_path, server, jax_first):
    root, _ids, vecs = built(tmp_path)
    srv = server(root, warmup=False)
    hits, _gen = srv.search(clip_uuid="c7", top_k=3)
    assert hits[0][0][0] == "c7" and hits[0][0][1] == pytest.approx(1.0, abs=1e-4)
    assert_hits_equal(hits, tci.CorpusIndex.open(root, device="cpu").query(vecs[7:8], top_k=3))
    with pytest.raises(KeyError, match="not indexed"):
        srv.search(clip_uuid="not-indexed")


def test_text_search_is_provenance_gated_and_matches_corpus_index_query(tmp_path, server, monkeypatch, jax_first):
    root, _ids, _vecs = built(tmp_path)
    srv = server(root, text_model="clip-text-tiny-test")
    monkeypatch.delenv(tstore.ALLOW_RANDOM_ENV, raising=False)
    with pytest.raises(ProvenanceError, match="CURATE_INDEX_ALLOW_RANDOM"):
        srv.search(text="a red car")
    monkeypatch.setenv(tstore.ALLOW_RANDOM_ENV, "1")
    texts = ["a red car", "a cat on a wall", "night street in the rain"]
    got = [srv.search(text=t, top_k=4)[0][0] for t in texts]
    tower = CLIPTextEmbeddings("clip-text-tiny-test", device="cpu")
    tower.setup()
    assert_hits_equal(got, tci.CorpusIndex.open(root, device="cpu").query(tower.encode_texts(texts), top_k=4))
    assert all(len(h) == 4 for h in got)


def test_text_tower_of_another_width_is_refused(tmp_path, server, monkeypatch, jax_first):
    root, _ids, _vecs = built(tmp_path, dim=DIM + 8)
    monkeypatch.setenv(tstore.ALLOW_RANDOM_ENV, "1")
    srv = server(root, text_model="clip-text-tiny-test", warmup=False)
    with pytest.raises(ValueError, match="text tower dim 16 != index dim 24"):
        srv.search(text="a red car")


def test_close_drains_and_refuses(tmp_path, server, jax_first):
    root, _ids, vecs = built(tmp_path)
    srv = server(root, warmup=False)
    srv.close()
    srv.close()  # idempotent
    assert not srv._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        srv.search(vecs[0])


def test_a_snapshot_is_isolated_until_adoption(tmp_path, server, jax_first):
    root, ids, vecs = built(tmp_path)
    store = tstore.IndexStore(root)
    new = (np.random.default_rng(2).standard_normal((4, DIM)) * 3).astype(np.float32)
    srv = server(root, adopt_interval_s=3600.0)
    before, gen = srv.search(new[0], top_k=3)
    store.write_pending_fragment("t0", [f"n{i}" for i in range(4)], new, model="m", provenance="ckpt")
    report = tcomp.compact_index(root, device="cpu")
    assert report["published"] and report["generation"] == 1
    again, gen_again = srv.search(new[0], top_k=3)  # still generation 0: n0 is invisible
    assert gen == gen_again == 0 and again == before and "n0" not in {h for h, _ in again[0]}
    assert srv.maybe_adopt() and not srv.maybe_adopt()
    after, gen_after = srv.search(new[0], top_k=3)
    assert gen_after == 1 and after[0][0][0] == "n0"
    assert srv.stats()["counts"]["generations_adopted"] == 1


@pytest.mark.parametrize("gc_drained", [False, True])
def test_adoption_drains_the_old_generation(gc_drained, tmp_path, server, jax_first):
    root, _ids, vecs = built(tmp_path)
    store = tstore.IndexStore(root)
    srv = server(root, adopt_interval_s=3600.0, gc_drained=gc_drained, warmup_budget=1 << 30)
    store.write_pending_fragment("t0", ["n0"], vecs[:1] * -1, model="m", provenance="ckpt")
    report = tcomp.compact_index(root, device="cpu")
    superseded = store.read_manifest()["superseded"]
    assert superseded
    srv.maybe_adopt()
    assert all(key[0] == 1 for key in srv.cache._entries)  # generation 0's shards drained
    on_disk = {rel for cid in store.cluster_fragment_counts()
               for rel, _ in store.fragment_info(f"clusters/{store.cluster_dir(cid)}")}
    assert bool(set(superseded) & on_disk) != gc_drained
    assert srv.search(vecs[0], top_k=2)[1] == report["generation"]


# -- compaction -------------------------------------------------------------------


def both(tmp_path, root: str):
    """A JAX-side copy of the index at ``root``."""
    copy = tmp_path / "jax_copy"
    shutil.copytree(root, copy)
    return str(copy)


def assert_same_index(t_root: str, j_root: str):
    t, j = tstore.IndexStore(t_root), jstore.IndexStore(j_root)
    assert t.load_meta() == j.load_meta()
    np.testing.assert_allclose(t.load_centroids(), j.load_centroids(), atol=ATOL)
    assert t.current_generation() == j.current_generation()
    tm, jm = t.read_manifest(), j.read_manifest()
    assert tm["clusters"].keys() == jm["clusters"].keys()
    for cid, info in tm["clusters"].items():
        assert info["fragments"] == jm["clusters"][cid]["fragments"] and info["rows"] == jm["clusters"][cid]["rows"]
        assert t.read_fragments(info["fragments"])[0] == j.read_fragments(jm["clusters"][cid]["fragments"])[0]
    assert {k: v for k, v in tm.items() if k not in ("clusters", "meta")} == {
        k: v for k, v in jm.items() if k not in ("clusters", "meta")}
    assert t.list_pending() == j.list_pending() == []


def compact_both(t_root: str, j_root: str, **kw):
    got = tcomp.compact_index(t_root, device="cpu", **kw)
    want = jcomp.compact_index(j_root, **kw)
    assert {k: v for k, v in got.items() if k != "index_path"} == {k: v for k, v in want.items() if k != "index_path"}
    assert_same_index(t_root, j_root)
    return got


def test_fold_pending_without_duplicates_matches_the_reference(tmp_path, jax_first):
    root, ids, _vecs = built(tmp_path)
    j_root = both(tmp_path, root)
    new = np.random.default_rng(3).standard_normal((8, DIM)).astype(np.float32)
    new_ids = [f"n{i}" for i in range(8)]
    for r, store in ((root, tstore.IndexStore(root)), (j_root, jstore.IndexStore(j_root))):
        store.write_pending_fragment("t0", new_ids, new, model="m", provenance="checkpoint:ab")
        store.write_pending_fragment("t1", new_ids, new, model="m", provenance="checkpoint:ab")  # a re-run
        store.write_pending_fragment("t2", ids[:3], _vecs[:3], model="m", provenance="checkpoint:ab")
    report = compact_both(root, j_root)
    assert report["published"] and report["generation"] == 1 and report["folded"] == 8
    assert report["duplicates_dropped"] == 11 and report["pending_cleared"] == 3
    index = tci.CorpusIndex.open(root, device="cpu")
    assert index.meta["num_vectors"] == len(ids) + 8
    assert [h[0][0] for h in index.query(new, top_k=1)] == new_ids
    assert not compact_both(root, j_root)["published"]  # nothing left to do


@pytest.mark.parametrize("case", ["random_refused", "duplicates_only", "other_model"])
def test_pending_that_changes_nothing_clears_without_publishing(case, tmp_path, monkeypatch, jax_first):
    monkeypatch.delenv(tstore.ALLOW_RANDOM_ENV, raising=False)
    root, ids, vecs = built(tmp_path)
    j_root = both(tmp_path, root)
    rows = {"random_refused": (["r0", "r1"], vecs[:2] * -1, "m", "random"),
            "duplicates_only": (ids[:4], vecs[:4], "m", "ckpt"),
            "other_model": (["o0"], vecs[:1] * -1, "other", "ckpt")}[case]
    for store in (tstore.IndexStore(root), jstore.IndexStore(j_root)):
        store.write_pending_fragment("t0", rows[0], rows[1], model=rows[2], provenance=rows[3])
    report = compact_both(root, j_root)
    assert not report["published"] and report["pending_cleared"] == 1


def test_rebalance_splits_a_skewed_cluster_like_the_reference(tmp_path, jax_first):
    rng = np.random.default_rng(4)
    centres = rng.standard_normal((3, DIM)).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    vecs = np.concatenate([c + 0.03 * rng.standard_normal((n, DIM)) for c, n in zip(centres, (200, 10, 10))]
                          ).astype(np.float32)
    ids = [f"v{i}" for i in range(len(vecs))]
    root = str(tmp_path / "skew")
    jci.CorpusIndex.build(root, ids, vecs, model="m", k=3)
    j_root = both(tmp_path, root)
    report = compact_both(root, j_root, rebalance_factor=1.5, min_split_rows=32)
    assert report["published"] and report["clusters_split"] >= 1 and report["rows_moved"] > 0
    index = tci.CorpusIndex.open(root, device="cpu")
    assert index.centroids.shape[0] > 3
    queries = near(rng, vecs, 7)
    assert recall(index.query(queries, top_k=5, nprobe=3), queries, ids, vecs) >= 0.95


def test_refresh_and_force_publish_like_the_reference(tmp_path, jax_first):
    root, _ids, _vecs = built(tmp_path)
    j_root = both(tmp_path, root)
    first = compact_both(root, j_root, force=True)
    assert first["published"] and first["generation"] == 1
    second = compact_both(root, j_root, force=True, refresh_centroids=False)
    assert second["generation"] == 2 and second["base_generation"] == 1


def test_absorbs_post_publish_adds_and_gc_keeps_them(tmp_path, jax_first):
    root, _ids, _vecs = built(tmp_path)
    j_root = both(tmp_path, root)
    compact_both(root, j_root, force=True)
    added = np.random.default_rng(5).standard_normal((4, DIM)).astype(np.float32)
    tci.CorpusIndex.open(root, device="cpu").add([f"a{i}" for i in range(4)], added)
    jci.CorpusIndex.open(j_root).add([f"a{i}" for i in range(4)], added)
    report = compact_both(root, j_root)
    assert report["published"] and report["absorbed"] == 4
    t_store, j_store = tstore.IndexStore(root), jstore.IndexStore(j_root)
    assert tcomp.gc_index(t_store) == jcomp.gc_index(j_store) > 0
    assert t_store.list_manifests() == j_store.list_manifests() == [report["generation"]]
    hits = tci.CorpusIndex.open(root, device="cpu").query(added, top_k=1)
    assert [h[0][0] for h in hits] == [f"a{i}" for i in range(4)]


def test_gc_superseded_and_the_full_sweep(tmp_path, jax_first):
    root, ids, vecs = built(tmp_path)
    j_root = both(tmp_path, root)
    for store in (tstore.IndexStore(root), jstore.IndexStore(j_root)):
        store.write_pending_fragment("t0", ["n0"], vecs[:1] * -1, model="m", provenance="ckpt")
    t_store, j_store = tstore.IndexStore(root), jstore.IndexStore(j_root)
    t_old, j_old = t_store.read_manifest(), j_store.read_manifest()  # generation 0, the live view
    report = compact_both(root, j_root)
    manifest = t_store.read_manifest()
    assert manifest["superseded"]
    assert tcomp.gc_superseded(t_store, t_old, manifest) == jcomp.gc_superseded(
        j_store, j_old, j_store.read_manifest()) == len(manifest["superseded"])
    live = {f for c in t_store.build_live_manifest()["clusters"].values() for f in c["fragments"]}
    assert live == {f for c in manifest["clusters"].values() for f in c["fragments"]}
    assert tcomp.gc_index(t_store) == 0 and tcomp.gc_index(tstore.IndexStore(str(tmp_path / "nothing"))) == 0
    index = tci.CorpusIndex.open(root, device="cpu")
    assert recall(index.query(vecs[:8], top_k=5, nprobe=3), vecs[:8], ids, vecs) >= 0.95
    assert report["generation"] == 1
    assert json.loads((tmp_path / "idx" / "MANIFEST.json").read_text())["generation"] == 1


def test_compaction_thread_runs_passes_and_lets_device_faults_through(tmp_path, monkeypatch, jax_first):
    root, _ids, vecs = built(tmp_path)
    tstore.IndexStore(root).write_pending_fragment("t0", ["n0"], vecs[:1] * -1, model="m", provenance="ckpt")
    thread = tcomp.CompactionThread(root, interval_s=0.01, device="cpu")
    thread.start()
    for _ in range(500):
        if thread.passes:
            break
        threading.Event().wait(0.01)
    thread.stop(timeout=10)
    assert not thread.is_alive() and thread.passes >= 1 and thread.last_report["folded"] == 1
    quiet = tcomp.CompactionThread(str(tmp_path / "missing"), device="cpu")
    assert quiet.run_once() is None and quiet.passes == 0  # logged, index unchanged

    def fault(root, **kw):
        raise KernelError("launch failed")

    monkeypatch.setattr(tcomp, "compact_index", fault)
    with pytest.raises(KernelError):
        tcomp.CompactionThread(root, device="cpu").run_once()


def test_compaction_while_queries_are_in_flight(tmp_path, server, jax_first):
    """Queries hammer the server while compaction folds pending rows and
    publishes: every answer comes from generation 0 or the new one, the
    indexed content answers alike in both, recall@5 >= 0.95 before and after
    adoption, and the folded rows are found after it."""
    root, ids, vecs = built(tmp_path, per=60)
    store = tstore.IndexStore(root)
    rng = np.random.default_rng(6)
    queries = near(rng, vecs, 6)
    srv = server(root, batch_window_s=0.001, adopt_interval_s=0.0)
    baseline = [srv.search(q, top_k=5)[0][0] for q in queries]
    assert recall(baseline, queries, ids, vecs) >= 0.95
    new = (rng.standard_normal((16, DIM)) * 3).astype(np.float32)  # far from the corpus
    store.write_pending_fragment("t0", [f"n{i}" for i in range(16)], new, model="m", provenance="ckpt")
    stop = threading.Event()
    observed: list[tuple[int, int, list]] = []
    errors: list[BaseException] = []

    def hammer(tid):
        i = 0
        while not stop.is_set():
            qi = (tid * 7 + i) % len(queries)
            try:
                hits, gen = srv.search(queries[qi], top_k=5)
            except Exception as e:
                errors.append(e)
                return
            observed.append((qi, gen, [h for h, _ in hits[0]]))
            i += 1

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    report = tcomp.compact_index(root, device="cpu")
    for _ in range(200):
        if srv.generation >= report["generation"]:
            break
        srv.search(queries[0], top_k=5)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    assert report["published"] and report["folded"] == 16
    assert {g for _qi, g, _h in observed} <= {0, report["generation"]}
    assert srv.generation == report["generation"]
    for qi, _gen, hit_ids in observed:
        assert hit_ids == [h for h, _ in baseline[qi]]
    after = [srv.search(q, top_k=5)[0][0] for q in queries]
    assert recall(after, queries, ids, vecs) >= 0.95
    hits, gen = srv.search(new[0], top_k=1)
    assert gen == report["generation"] and hits[0][0][0] == "n0"
