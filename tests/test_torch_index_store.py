"""Port parity: the corpus index's on-disk layout (``dedup/index_store.py``).

The port writes the reference's files: the same ``meta.json``, the same
parquet fragments byte for byte (``embedding`` as ``list<double>``, built
from the numpy buffer instead of one Python float per value), the same
manifests. An index written by either package opens in the other with the
same ids, vectors and parquet schema (``pq.read_schema``). Vectors compare
exactly: both sides store the same float32 values widened to float64.
"""

import json
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from cosmos_curate_tpu.dedup import index_store as jstore
from cosmos_curate_tpu.dedup.corpus_index import CorpusIndex as JCorpusIndex
from cosmos_curate_tpu.utils import schema_stamp as jstamp
from cosmos_curate_tpu_torch.dedup import index_store as tstore
from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex as TCorpusIndex
from cosmos_curate_tpu_torch.utils import schema_stamp as tstamp
from tests.fixtures.object_stores import object_stores  # noqa: F401  (fixture)
from tests.test_torch_dedup import jax_first  # noqa: F401  (fixture)

DIM = 16


def corpus(seed: int, n_clusters: int = 5, per: int = 24, dim: int = DIM):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    vecs = np.concatenate([c + 0.3 * rng.standard_normal((per, dim)) for c in centres]).astype(np.float32)
    return [f"clip-{i:04d}" for i in range(len(vecs))], vecs


def fragments(root) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.parquet"))}


def test_normalize_rows_is_bit_equal():
    _, x = corpus(0)
    x[3] = 0.0
    np.testing.assert_array_equal(tstore.normalize_rows(x), jstore.normalize_rows(x))
    assert tstore.ALLOW_RANDOM_ENV == jstore.ALLOW_RANDOM_ENV


@pytest.mark.parametrize("value,allowed", [("", False), ("1", True), ("true", True), ("ON", True), ("0", False)])
def test_allow_random_provenance_reads_the_env_as_the_reference(value, allowed, monkeypatch):
    monkeypatch.setenv(tstore.ALLOW_RANDOM_ENV, value)
    assert tstore.allow_random_provenance() is jstore.allow_random_provenance() is allowed


@pytest.mark.parametrize("rows", [1, 7, 60])
def test_pending_fragment_bytes_and_schema_match_the_reference(rows, tmp_path):
    ids, x = corpus(1)
    ids, x = ids[:rows], x[:rows] * 3.0
    kw = dict(model="video-embed-tpu", provenance="checkpoint:feedc0ffee12")
    t_path = tstore.IndexStore(str(tmp_path / "t")).write_pending_fragment("chunk-00000", ids, x, **kw)
    j_path = jstore.IndexStore(str(tmp_path / "j"), backend="parquet").write_pending_fragment("chunk-00000", ids, x,
                                                                                              **kw)
    assert t_path.endswith("/pending/chunk-00000.parquet")
    t_bytes, j_bytes = open(t_path, "rb").read(), open(j_path, "rb").read()
    assert t_bytes == j_bytes
    schema = pq.read_schema(t_path)
    assert schema.equals(pq.read_schema(j_path), check_metadata=True)
    emb = schema.field("embedding").type
    assert pa.types.is_list(emb) and emb.value_type == pa.float64()
    got = tstore.IndexStore(str(tmp_path / "t")).read_pending()
    want = jstore.IndexStore(str(tmp_path / "j")).read_pending()
    assert got[0] == want[0] == ids and got[2:] == want[2:]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], jstore.normalize_rows(x))
    assert got[1].dtype == np.float32


def test_pending_listing_read_and_clear(tmp_path):
    ids, x = corpus(2)
    store = tstore.IndexStore(str(tmp_path / "idx"))
    assert store.list_pending() == [] and store.read_pending()[0] == []
    for c in range(3):
        store.write_pending_fragment(f"tag-{c}", ids[c * 10:(c + 1) * 10], x[c * 10:(c + 1) * 10], model="m",
                                     provenance="random" if c == 1 else "ckpt")
    assert [p.rsplit("/", 1)[1] for p in store.list_pending()] == ["tag-0.parquet", "tag-1.parquet", "tag-2.parquet"]
    got_ids, vecs, models, provs = store.read_pending()
    assert got_ids == ids[:30] and vecs.shape == (30, DIM) and models == ["m"] * 30
    assert provs == ["ckpt"] * 10 + ["random"] * 10 + ["ckpt"] * 10
    assert store.clear_pending() == 3 and store.list_pending() == []


def test_build_writes_the_reference_layout(tmp_path, jax_first):
    """The same rows through both packages' ``CorpusIndex.build`` (the port
    given JAX's first k-means pick): the same files, ``meta.json`` and
    cluster fragments byte for byte, centroids within 1e-5."""
    ids, x = corpus(3)
    JCorpusIndex.build(str(tmp_path / "j"), ids, x, model="m", k=5, provenance="ckpt")
    TCorpusIndex.build(str(tmp_path / "t"), ids, x, model="m", k=5, provenance="ckpt", device="cpu")
    files = sorted(str(p.relative_to(tmp_path / "t")) for p in (tmp_path / "t").rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(tmp_path / "j")) for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert "meta.json" in files and "centroids.npy" in files
    assert all(f.startswith("clusters/c0000") for f in files if f.endswith(".parquet"))
    assert (tmp_path / "t/meta.json").read_bytes() == (tmp_path / "j/meta.json").read_bytes()
    meta = json.loads((tmp_path / "t/meta.json").read_text())
    assert meta == {"version": 1, "model": "m", "dim": DIM, "k": 5, "num_vectors": len(ids), "nprobe_default": 8,
                    "provenance": "ckpt", "backend": "parquet"}
    assert fragments(tmp_path / "t") == fragments(tmp_path / "j")
    np.testing.assert_allclose(np.load(tmp_path / "t/centroids.npy"), np.load(tmp_path / "j/centroids.npy"),
                               atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_index_written_by_one_package_opens_in_the_other(writer, tmp_path, jax_first):
    ids, x = corpus(4)
    root = tmp_path / "idx"
    if writer == "jax":
        JCorpusIndex.build(str(root), ids, x, model="m", k=4)
        jstore.IndexStore(str(root)).write_pending_fragment("late", ["late-0"], x[:1], model="m")
    else:
        TCorpusIndex.build(str(root), ids, x, model="m", k=4, device="cpu")
        tstore.IndexStore(str(root)).write_pending_fragment("late", ["late-0"], x[:1], model="m")
    # the reference's schema: a fragment the JAX writer writes elsewhere
    want_schema = pq.read_schema(jstore.IndexStore(str(tmp_path / "ref"), backend="parquet").append_cluster(
        0, ids[:2], x[:2]))
    t, j = tstore.IndexStore(str(root)), jstore.IndexStore(str(root))
    assert t.exists() and j.exists() and t.backend == j.backend == "parquet"
    assert t.load_meta() == j.load_meta()
    np.testing.assert_array_equal(t.load_centroids(), j.load_centroids())
    assert t.cluster_fragment_counts() == j.cluster_fragment_counts()
    seen = []
    for cid in sorted(j.cluster_fragment_counts()):
        t_ids, t_vecs = t.read_cluster(cid)
        j_ids, j_vecs = j.read_cluster(cid)
        assert t_ids == j_ids
        np.testing.assert_array_equal(t_vecs, j_vecs)
        seen += t_ids
        for rel, _size in t.fragment_info(f"clusters/{t.cluster_dir(cid)}"):
            assert pq.read_schema(root / rel).equals(want_schema, check_metadata=True)
    assert sorted(seen) == sorted(ids)
    assert t.fragment_info("clusters/c00000") == j.fragment_info("clusters/c00000")
    assert [p.rsplit("/", 1)[1] for p in t.list_pending()] == ["late.parquet"]
    np.testing.assert_array_equal(t.read_pending()[1], j.read_pending()[1])


def test_manifests_publish_read_and_list_like_the_reference(tmp_path, jax_first):
    ids, x = corpus(5)
    root = tmp_path / "idx"
    TCorpusIndex.build(str(root), ids, x, model="m", k=5, device="cpu")
    t, j = tstore.IndexStore(str(root)), jstore.IndexStore(str(root))
    assert t.current_generation() == j.current_generation() == 0
    live = t.build_live_manifest()
    assert live == j.build_live_manifest()
    assert live["generation"] == 0 and live["schema_version"] == 2 and len(live["clusters"]) == 5
    assert all(info["bytes"] > 0 and info["rows"] == 0 for info in live["clusters"].values())
    with pytest.raises(ValueError, match="start at 1"):
        t.publish_manifest({**live, "generation": 0})
    assert t.publish_manifest({**live, "generation": 1}) == 1
    assert j.current_generation() == t.current_generation() == 1
    assert t.read_manifest() == j.read_manifest()
    assert json.loads((root / "MANIFEST.json").read_text()) == {"generation": 1, "schema_version": 2}
    j.publish_manifest({**live, "generation": 2})
    assert t.current_generation() == 2 and t.list_manifests() == j.list_manifests() == [1, 2]
    assert t.read_manifest(1)["generation"] == 1 and t.read_manifest(0)["generation"] == 0
    t.delete_manifest(1)
    assert t.list_manifests() == [2]


def test_read_fragments_pins_the_manifest_set(tmp_path, jax_first):
    ids, x = corpus(6)
    root = tmp_path / "idx"
    TCorpusIndex.build(str(root), ids, x, model="m", k=3, device="cpu")
    store = tstore.IndexStore(str(root))
    manifest = store.build_live_manifest()
    cid, info = next(iter(manifest["clusters"].items()))
    pinned_ids, pinned_vecs = store.read_fragments(info["fragments"])
    direct_ids, direct_vecs = store.read_cluster(int(cid))
    assert pinned_ids == direct_ids
    np.testing.assert_array_equal(pinned_vecs, direct_vecs)
    store.append_cluster(int(cid), ["extra-0"], x[:1])  # after the manifest: invisible to the pin
    assert store.read_fragments(info["fragments"])[0] == pinned_ids
    assert "extra-0" in store.read_cluster(int(cid))[0]


def test_read_cluster_drops_a_row_seen_twice(tmp_path):
    ids, x = corpus(7)
    store = tstore.IndexStore(str(tmp_path / "idx"))
    store.append_cluster(0, ids[:5], x[:5])
    store.append_cluster(0, ids[3:8], x[3:8])  # 3 and 4 again, as between a publish and its GC
    got_ids, vecs = store.read_cluster(0)
    j_ids, j_vecs = jstore.IndexStore(str(tmp_path / "idx")).read_cluster(0)
    assert got_ids == j_ids and len(got_ids) == 8 == len(set(got_ids))
    np.testing.assert_array_equal(vecs, j_vecs)


def test_manifest_versions_upgrade_and_refuse_like_the_reference(tmp_path, jax_first):
    ids, x = corpus(8)
    root = tmp_path / "idx"
    TCorpusIndex.build(str(root), ids, x, model="m", k=3, device="cpu")
    store = tstore.IndexStore(str(root))
    v1 = {k: v for k, v in store.build_live_manifest().items() if k != "schema_version"}
    (root / "manifests").mkdir()
    (root / "manifests" / "gen-000001.json").write_text(json.dumps({**v1, "generation": 1}))
    (root / "MANIFEST.json").write_text(json.dumps({"generation": 1}))
    got = store.read_manifest()
    assert got == jstore.IndexStore(str(root)).read_manifest() and got["schema_version"] == 2
    assert tstamp.SCHEMA_VERSIONS["index-manifest"] == jstamp.SCHEMA_VERSIONS["index-manifest"]
    (root / "manifests" / "gen-000001.json").write_text(json.dumps({**v1, "generation": 1, "schema_version": 3}))
    for reader in (store, jstore.IndexStore(str(root))):
        with pytest.raises(RuntimeError, match="schema v3 but this build publishes v2"):
            reader.read_manifest()
    with pytest.raises(tstamp.SchemaVersionError):
        tstamp.upgrade({"schema_version": 3}, "index-manifest")
    (root / "MANIFEST.json").write_text("{not json")
    with pytest.raises(RuntimeError, match="unreadable manifest pointer"):
        store.current_generation()


@pytest.mark.parametrize("how", ["argument", "meta", "pending_dataset", "cluster_dataset"])
def test_the_lance_backend_is_refused(how, tmp_path):
    root = tmp_path / "idx"
    root.mkdir()
    kw = {}
    if how == "argument":
        kw["backend"] = "lance"
    elif how == "meta":
        (root / "meta.json").write_text(json.dumps({"backend": "lance", "dim": 4}))
    elif how == "pending_dataset":
        (root / "pending" / "chunk.lance").mkdir(parents=True)
    else:
        (root / "clusters" / "c00000" / "frag.lance").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 21"):
        tstore.IndexStore(str(root), **kw)


def test_unknown_backend_and_unreadable_meta_raise(tmp_path):
    with pytest.raises(ValueError, match="unknown index backend"):
        tstore.IndexStore(str(tmp_path / "a"), backend="sqlite")
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "meta.json").write_text("{")
    with pytest.raises(RuntimeError, match="unreadable index meta"):
        tstore.IndexStore(str(tmp_path / "b"))


def test_delete_fragments_counts_like_the_reference(tmp_path, jax_first):
    ids, x = corpus(9)
    TCorpusIndex.build(str(tmp_path / "idx"), ids, x, model="m", k=3, device="cpu")
    shutil.copytree(tmp_path / "idx", tmp_path / "copy")
    t, j = tstore.IndexStore(str(tmp_path / "idx")), jstore.IndexStore(str(tmp_path / "copy"))
    rels = [rel for rel, _ in t.fragment_info("clusters/c00000")] + ["clusters/c00009/gone.parquet"]
    assert t.delete_fragments(rels) == j.delete_fragments(rels) == 2
    assert t.cluster_fragment_counts() == j.cluster_fragment_counts()
    assert 0 not in t.cluster_fragment_counts()


# -- remote roots ----------------------------------------------------------------


def _remote_fragments(root: str) -> dict[str, bytes]:
    from cosmos_curate_tpu_torch.storage.client import get_storage_client

    client = get_storage_client(root)
    return {rel: client.read_bytes(f"{root}/{rel}") for rel in client.list_relative(root, suffixes=(".parquet",))}


def test_a_gs_root_builds_consolidates_and_queries_like_a_local_root(object_stores, tmp_path, jax_first):  # noqa: F811
    """The same fragments built, consolidated and queried at a ``gs://``
    root and at a local one: the same meta, fragment bytes and answers; the
    JAX package opens the remote index and answers the same."""
    from cosmos_curate_tpu_torch.dedup import corpus_index as tci

    ids, x = corpus(21)
    roots = {"local": str(tmp_path / "idx"), "remote": "gs://indexes/corpus"}
    answers, metas, frags = {}, {}, {}
    for name, root in roots.items():
        index = TCorpusIndex.build(root, ids[:80], x[:80], model="m", k=4, device="cpu")
        store = tstore.IndexStore(root)
        store.write_pending_fragment("chunk-00000", ids[80:], x[80:], model="m", provenance="checkpoint:abc")
        assert tci.consolidate_index(root, device="cpu")["consolidated"] == len(ids) - 80
        index = TCorpusIndex.open(root, device="cpu")
        answers[name] = index.query(x[::7], top_k=5, nprobe=2)
        metas[name] = store.load_meta()
        frags[name] = fragments(tmp_path / "idx") if name == "local" else _remote_fragments(root)
    assert metas["remote"] == metas["local"] and metas["remote"]["num_vectors"] == len(ids)
    assert frags["remote"] == frags["local"]
    assert answers["remote"] == answers["local"]
    j_answers = JCorpusIndex.open(roots["remote"]).query(x[::7], top_k=5, nprobe=2)
    assert [[h for h, _ in row] for row in j_answers] == [[h for h, _ in row] for row in answers["remote"]]


def test_a_remote_root_is_never_globbed_as_a_local_path(object_stores, tmp_path, monkeypatch):  # noqa: F811
    """Lance stays unported at local roots, but a remote root is parquet, as
    in the reference: a local directory named like the URL, holding lance
    fragments, changes nothing, and ``backend="lance"`` falls back with a
    warning."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "gs:" / "indexes" / "corpus" / "pending" / "chunk.lance").mkdir(parents=True)
    for kw in ({}, {"backend": "lance"}):
        store = tstore.IndexStore("gs://indexes/corpus", **kw)
        assert store.backend == jstore.IndexStore("gs://indexes/corpus", **kw).backend == "parquet"
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 21"):
        tstore.IndexStore("gs:/indexes/corpus")  # the local twin
