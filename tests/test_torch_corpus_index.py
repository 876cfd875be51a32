"""Port parity: the corpus index (``dedup/corpus_index.py``).

The same numpy inputs go through the JAX package and the port (the port on
the CPU, its scoring products' plain path; k-means given the JAX package's
first pick, as ``tests/test_torch_dedup.py`` does). Bars: centroids and
similarities within atol 1e-5 (fp32 products summed in another order);
identical cluster contents, top-k ids, kept and removed sets and
``duplicate_of``. Corpora with exact duplicate rows pin the top-k's tie
order (equal similarities, lower index first, as ``jax.lax.top_k``).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_curate_tpu.dedup import corpus_index as jci
from cosmos_curate_tpu.dedup import index_store as jstore
from cosmos_curate_tpu_torch.dedup import corpus_index as tci
from cosmos_curate_tpu_torch.dedup import index_store as tstore
from tests.test_torch_dedup import jax_first  # noqa: F401  (fixture)

ATOL = 1e-5
DIM = 24


def corpus(seed: int, n_clusters: int = 6, per: int = 30, dim: int = DIM, spread: float = 0.3):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    vecs = np.concatenate([c + spread * rng.standard_normal((per, dim)) for c in centres]).astype(np.float32)
    return [f"clip-{i:04d}" for i in range(len(vecs))], vecs


def with_duplicate_rows(ids, vecs, every: int = 5):
    """Every ``every``-th row repeated exactly under a new id, right after
    its original: equal similarities for every query."""
    out_ids, out_vecs = [], []
    for i, (u, v) in enumerate(zip(ids, vecs, strict=True)):
        out_ids.append(u)
        out_vecs.append(v)
        if i % every == 0:
            out_ids.append(f"{u}-twin")
            out_vecs.append(v.copy())
    return out_ids, np.stack(out_vecs)


def assert_hits_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert [h for h, _ in g] == [h for h, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=ATOL)


def both_built(tmp_path, ids, vecs, **kw):
    j = jci.CorpusIndex.build(str(tmp_path / "j"), ids, vecs, **kw)
    t = tci.CorpusIndex.build(str(tmp_path / "t"), ids, vecs, device="cpu", **kw)
    return j, t


# -- the shard cache ----------------------------------------------------------


def shard(rows: int, seed: int = 0):
    return [f"s{seed}-{i}" for i in range(rows)], np.random.default_rng(seed).standard_normal((rows, 8)).astype(
        np.float32)


CACHE_SCRIPTS = {
    # byte budget: five shards of ~1.5 KB under a budget of three
    "byte_budget": (3 * tci.shard_nbytes(*shard(40)), None,
                    [("get", 0, c, ()) for c in range(5)] + [("get", 0, 3, ()), ("get", 0, 0, ())]),
    # one fat shard cannot evict the pinned probe union
    "pinned_probe_union": (3 * tci.shard_nbytes(*shard(40)), None,
                           [("get", 0, c, ((0, 0), (0, 1), (0, 2))) for c in range(3)]
                           + [("fat", 0, 9, ((0, 0), (0, 1), (0, 2))), ("get", 0, 3, ((0, 0), (0, 1), (0, 2)))]),
    "drop_generation": (1 << 20, None,
                        [("get", 1, c, ()) for c in range(3)] + [("get", 2, c, ()) for c in range(2)]
                        + [("drop", 1), ("get", 1, 0, ()), ("drop", 7)]),
    "entry_cap": (1 << 20, 2, [("get", 0, c, ()) for c in range(4)] + [("get", 0, 2, ()), ("invalidate", 0, 3),
                                                                        ("get", 0, 1, ())]),
}


@pytest.mark.parametrize("script", sorted(CACHE_SCRIPTS))
def test_shard_cache_matches_the_reference(script):
    """The same loads through both caches: the same resident keys in LRU
    order, hits, misses and evictions after every step."""
    budget, cap, steps = CACHE_SCRIPTS[script]
    caches = (jci.ShardCache(budget, max_entries=cap), tci.ShardCache(budget, max_entries=cap))
    loads = {cache: 0 for cache in caches}
    for step in steps:
        for cache in caches:
            op = step[0]
            if op in ("get", "fat"):
                _, gen, cid, pinned = step
                rows = 400 if op == "fat" else 40

                def loader(cache=cache, rows=rows, cid=cid):
                    loads[cache] += 1
                    return shard(rows, cid)

                ids, mat = cache.get(gen, cid, loader, frozenset(pinned))
                assert ids == shard(rows, cid)[0]
            elif op == "drop":
                cache.drop_generation(step[1])
            else:
                cache.invalidate(*step[1:])
        j, t = caches
        assert list(t._entries) == list(j._entries), step
        assert t.stats() == j.stats(), step
        assert loads[t] == loads[j]
    if script == "pinned_probe_union":
        assert (0, 9) not in t._entries and {(0, 0), (0, 1), (0, 2)} <= set(t._entries)
    if script == "drop_generation":
        assert all(k[0] != 1 or k == (1, 0) for k in t._entries)


def test_shard_cache_budget_follows_the_env(monkeypatch):
    monkeypatch.setenv(tci.CLUSTER_CACHE_BYTES_ENV, "12345")
    assert tci.ShardCache().budget == jci.ShardCache().budget == 12345
    assert tci.ShardCache(99).budget == 99
    monkeypatch.setenv(tci.CLUSTER_CACHE_ENTRIES_ENV, "3")
    assert tci._cluster_cache_entries() == jci._cluster_cache_entries() == 3
    assert tci.DEFAULT_CLUSTER_CACHE_BYTES == jci.DEFAULT_CLUSTER_CACHE_BYTES


# -- the scoring products -------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 8])
def test_topk_rows_keeps_lax_top_k_tie_order(k):
    """Rows full of exact ties: the same values and indices as
    ``jax.lax.top_k`` (equal values, lower index first)."""
    sims = np.random.default_rng(k).integers(0, 4, (16, 37)).astype(np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(sims), k)
    got_v, got_i = tci.topk_rows(torch.from_numpy(sims), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_device_topk_scores_each_job_against_its_rows():
    _, q = corpus(1, per=4)
    _, a = corpus(2, per=5)
    _, b = corpus(3, per=2)
    jobs = [([0, 3, 5], a, 4), ([1], b, 2), ([2, 4, 6, 7], a, 1)]
    got = tci.DeviceTopK("cpu")(q, jobs)
    for (rows, mat, k), (vals, idxs) in zip(jobs, got, strict=True):
        want_v, want_i = jax.lax.top_k(jnp.asarray(q[rows]) @ jnp.asarray(mat).T, k)
        np.testing.assert_allclose(vals, np.asarray(want_v), atol=ATOL)
        np.testing.assert_array_equal(idxs, np.asarray(want_i))
        assert vals.dtype == np.float32 and vals.shape == (len(rows), k)


@pytest.mark.parametrize("nprobe", [1, 3, 6, 50, -2])
def test_route_queries_matches_the_reference(nprobe):
    _, x = corpus(4)
    cents = tstore.normalize_rows(x[::30])
    q = tstore.normalize_rows(x[::7])
    assert tci.route_queries(q, cents, nprobe) == jci.route_queries(q, cents, nprobe)


# -- build / add / query ----------------------------------------------------------


@pytest.mark.parametrize("k,iters", [(6, 20), (9, 3)])
def test_build_matches_the_reference(k, iters, tmp_path, jax_first):
    ids, x = corpus(5)
    j, t = both_built(tmp_path, ids, x, model="m", k=k, iters=iters, seed=3)
    np.testing.assert_allclose(t.centroids, j.centroids, atol=ATOL)
    assert t.meta == j.meta and t.meta["k"] == k
    for cid in range(k):
        t_ids, t_vecs = t.store.read_cluster(cid)
        j_ids, j_vecs = j.store.read_cluster(cid)
        assert t_ids == j_ids
        np.testing.assert_array_equal(t_vecs, j_vecs)
    assert t.ops.snapshot()["adds"] == len(ids)


def test_build_add_and_query_edge_cases(tmp_path, jax_first):
    with pytest.raises(ValueError, match="zero vectors"):
        tci.CorpusIndex.build(str(tmp_path / "none"), [], np.zeros((0, 4), np.float32), device="cpu")
    with pytest.raises(FileNotFoundError):
        tci.CorpusIndex.open(str(tmp_path / "none"), device="cpu")
    ids, x = corpus(6)
    index = tci.CorpusIndex.build(str(tmp_path / "idx"), ids, x, model="m", device="cpu")
    assert index.meta["k"] == int(np.sqrt(len(ids)))  # K = sqrt(N) by default
    assert index.query(np.zeros((0, DIM), np.float32)) == []
    assert index.add([], np.zeros((0, DIM), np.float32)) == 0
    with pytest.raises(ValueError, match="vector dim"):
        index.add(["bad"], np.ones((1, DIM + 1), np.float32))
    assert tci.CorpusIndex.exists(str(tmp_path / "idx")) and not tci.CorpusIndex.exists(str(tmp_path / "none"))


@pytest.mark.parametrize("top_k,nprobe", [(5, 2), (1, None), (50, 6), (8, -3)])
@pytest.mark.parametrize("twins", [False, True])
def test_query_matches_the_reference(top_k, nprobe, twins, tmp_path, jax_first):
    """Both packages open ONE index (written by the JAX package) and answer
    the same queries: the same ids in the same order, similarities within
    1e-5; with twin rows, every tie resolved alike."""
    ids, x = corpus(7)
    if twins:
        ids, x = with_duplicate_rows(ids, x)
    root = str(tmp_path / "idx")
    jci.CorpusIndex.build(root, ids, x, model="m", k=6)
    rng = np.random.default_rng(8)
    q = np.concatenate([x[::9] + 0.05 * rng.standard_normal((len(x[::9]), DIM)),
                        rng.standard_normal((6, DIM))]).astype(np.float32)
    want = jci.CorpusIndex.open(root).query(q, top_k=top_k, nprobe=nprobe)
    index = tci.CorpusIndex.open(root, device="cpu")
    got = index.query(q, top_k=top_k, nprobe=nprobe)
    assert_hits_equal(got, want)
    assert all(len(row) == min(top_k, len(ids)) or nprobe not in (None, 6) for row in got)
    if twins and top_k >= 5:  # the tie is inside the top-k: both rows come back
        assert any(f"{h}-twin" in {u for u, _ in row} for row in got for h, _ in row)
    ops = index.ops.snapshot()
    assert ops["queries"] == len(q) and ops["probes"] > 0
    stats = index.stats()
    assert stats["num_vectors"] == len(ids) and stats["clusters_with_data"] == 6 and stats["backend"] == "parquet"
    assert stats["ops"]["queries"] == len(q) and stats["cache"]["resident_shards"] > 0


def test_add_routes_and_queries_match_the_reference(tmp_path, jax_first):
    ids, x = corpus(9)
    j, t = both_built(tmp_path, ids[:120], x[:120], model="m", k=5)
    new_ids, new_x = ids[120:], x[120:]
    t.query(x[:4])  # a warm cache must see the grown shards
    assert t.add(new_ids, new_x) == j.add(new_ids, new_x) == len(new_ids)
    assert t.meta == j.meta and t.meta["num_vectors"] == len(ids)
    for cid in range(5):
        assert t.store.read_cluster(cid)[0] == j.store.read_cluster(cid)[0]
    assert_hits_equal(t.query(x[::11], top_k=6), j.query(x[::11], top_k=6))
    assert t.stats()["fragments"] > 5


# -- incremental dedup ----------------------------------------------------------


def dedup_batch(seed: int, ids, x):
    """A batch of near-copies of indexed rows (cosine > 0.999), fresh rows,
    and near-copies of earlier fresh rows (batch-internal duplicates)."""
    rng = np.random.default_rng(seed)
    copies = x[::13] + 1e-3 * rng.standard_normal((len(x[::13]), x.shape[1])).astype(np.float32)
    fresh = (rng.standard_normal((8, x.shape[1])) * 2).astype(np.float32)
    inner = fresh[:3] + 1e-3 * rng.standard_normal((3, x.shape[1])).astype(np.float32)
    batch = np.concatenate([copies[:4], fresh, copies[4:], inner])
    names = ([f"copy-{i}" for i in range(4)] + [f"fresh-{i}" for i in range(8)]
             + [f"copy-{i}" for i in range(4, len(copies))] + [f"inner-{i}" for i in range(3)])
    return names, batch


@pytest.mark.parametrize("eps,nprobe", [(0.07, None), (0.07, 1), (0.3, 3), (1e-4, 6)])
def test_incremental_dedup_matches_the_reference(eps, nprobe, tmp_path, jax_first):
    ids, x = corpus(10)
    ids, x = with_duplicate_rows(ids, x, every=17)
    j, t = both_built(tmp_path, ids, x, model="m", k=6)
    names, batch = dedup_batch(11, ids, x)
    want = jci.incremental_dedup(j, names, batch, eps=eps, nprobe=nprobe)
    got = tci.incremental_dedup(t, names, batch, eps=eps, nprobe=nprobe)
    assert got == want
    assert set(got["kept"]) | set(got["removed"]) == set(names)
    if eps == 0.07:
        assert {n for n in got["removed"] if n.startswith("copy-")} == {n for n in names if n.startswith("copy-")}
        assert {got["duplicate_of"][f"inner-{i}"] for i in range(3)} == {f"fresh-{i}" for i in range(3)}
        assert not any(n.startswith("fresh-") for n in got["removed"])
    assert t.ops.snapshot()["duplicates"] == len(got["removed"])


def test_a_batch_the_index_already_holds_keeps_its_first(tmp_path, jax_first):
    """The index holds this very batch (the writer ran first): self-matches
    never remove a row, and of a duplicate pair the earlier stays."""
    ids, x = corpus(12)
    names, batch = dedup_batch(13, ids, x)
    j, t = both_built(tmp_path, ids + names, np.concatenate([x, batch]), model="m", k=6)
    want = jci.incremental_dedup(j, names, batch)
    got = tci.incremental_dedup(t, names, batch)
    assert got == want
    assert not any(n.startswith("fresh-") for n in got["removed"])
    assert tci.incremental_dedup(t, [], np.zeros((0, DIM), np.float32)) == {"kept": [], "removed": [],
                                                                            "duplicate_of": {}}


# -- consolidation ----------------------------------------------------------------


def write_pending(root, rows, provs=None, models=None):
    store = jstore.IndexStore(str(root), backend="parquet")
    for c, (ids, vecs) in enumerate(rows):
        store.write_pending_fragment(f"chunk-{c:05d}", ids, vecs, model=(models or ["m"] * len(rows))[c],
                                     provenance=(provs or ["checkpoint:abc"] * len(rows))[c])


@pytest.mark.parametrize("case", ["build_then_add", "random_refused", "random_allowed", "other_model"])
def test_consolidate_index_matches_the_reference(case, tmp_path, jax_first, monkeypatch):
    """The same pending fragments consolidated by each package into its own
    copy of the root: the same result, meta, cluster contents and (within
    1e-5) centroids; a second run routes into the existing index."""
    monkeypatch.delenv(tstore.ALLOW_RANDOM_ENV, raising=False)
    ids, x = corpus(14)
    provs = models = None
    if case.startswith("random"):
        provs = ["checkpoint:abc", "random", "checkpoint:abc"]
    if case == "random_allowed":
        monkeypatch.setenv(tstore.ALLOW_RANDOM_ENV, "1")
    if case == "other_model":
        models = ["m", "other", "m"]
    chunks = [(ids[i:i + 40], x[i:i + 40]) for i in (0, 40, 80)]
    write_pending(tmp_path / "j", chunks, provs, models)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    want = jci.consolidate_index(str(tmp_path / "j"), k=4)
    got = tci.consolidate_index(str(tmp_path / "t"), k=4, device="cpu")
    assert got == want
    assert got["consolidated"] == (80 if case in ("random_refused", "other_model") else 120)
    assert got["skipped_random"] == (40 if case == "random_refused" else 0)
    t, j = tstore.IndexStore(str(tmp_path / "t")), jstore.IndexStore(str(tmp_path / "j"))
    assert t.list_pending() == j.list_pending() == []
    assert t.load_meta() == j.load_meta()
    np.testing.assert_allclose(t.load_centroids(), j.load_centroids(), atol=ATOL)
    for cid in range(4):
        assert t.read_cluster(cid)[0] == j.read_cluster(cid)[0]
    # a second run routes against the trained centroids
    later = [(ids[120:], x[120:])]
    write_pending(tmp_path / "j", later)
    write_pending(tmp_path / "t", later)
    assert tci.consolidate_index(str(tmp_path / "t"), device="cpu") == jci.consolidate_index(str(tmp_path / "j"))
    assert t.load_meta() == j.load_meta()
    for cid in range(4):
        assert t.read_cluster(cid)[0] == j.read_cluster(cid)[0]


@pytest.mark.parametrize("allowed", [False, True])
def test_consolidating_only_random_rows_clears_them(allowed, tmp_path, monkeypatch, jax_first):
    monkeypatch.setenv(tstore.ALLOW_RANDOM_ENV, "1" if allowed else "")
    ids, x = corpus(15, per=4)
    write_pending(tmp_path / "t", [(ids, x)], provs=["random"])
    got = tci.consolidate_index(str(tmp_path / "t"), device="cpu")
    if allowed:
        assert got == {"consolidated": len(ids), "skipped_random": 0, "pending_cleared": 1}
    else:
        assert got == {"consolidated": 0, "skipped_random": len(ids), "pending_cleared": 1}
        assert not tci.CorpusIndex.exists(str(tmp_path / "t"))
    assert tci.consolidate_index(str(tmp_path / "empty"), device="cpu") == jci.consolidate_index(
        str(tmp_path / "empty2")) == {"consolidated": 0, "skipped_random": 0, "pending_cleared": 0}
