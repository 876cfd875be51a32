"""Port parity: the corpus index's lance backend (``dedup/index_store.py``)
and the parquet to lance export (``storage/lance_export.py``).

``pylance`` is not a dependency of either package, so lance is driven, as
the JAX package's tests drive it, through a stand-in module with lance's two
calls (``write_dataset`` / ``dataset``) that round-trips pyarrow tables and
makes each dataset a directory (``fake_lance``, a copy of the fixture in
``tests/dedup/test_corpus_index.py``). Both packages get the same inputs:
stores and indexes are built side by side (each root its own datasets),
k-means given the JAX package's first pick. Bars: ids, clusters, fragment
names, manifests and reports equal; vectors and scores within 1e-6. Where
``lance`` does not import, both packages fall back to parquet with one
warning, and a ``meta.json`` pins the backend.
"""

import sys
import types
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from cosmos_curate_tpu.dedup import compaction as jcomp
from cosmos_curate_tpu.dedup import corpus_index as jci
from cosmos_curate_tpu.dedup import index_store as jstore
from cosmos_curate_tpu.storage import lance_export as jexport
from cosmos_curate_tpu.storage.writers import write_parquet
from cosmos_curate_tpu_torch.dedup import compaction as tcomp
from cosmos_curate_tpu_torch.dedup import corpus_index as tci
from cosmos_curate_tpu_torch.dedup import index_store as tstore
from cosmos_curate_tpu_torch.storage import lance_export as texport
from tests.test_torch_dedup import jax_first  # noqa: F401  (fixture)

ATOL = 1e-6
DIM = 16


@pytest.fixture
def fake_lance(monkeypatch):
    """A lance stand-in with the real call shape (write_dataset/dataset)
    that round-trips tables; datasets are directories."""
    import pyarrow as pa

    store: dict[str, object] = {}
    mod = types.ModuleType("lance")

    def write_dataset(table, uri, mode="create"):
        uri = str(uri)
        if mode == "append" and uri in store:
            table = pa.concat_tables([store[uri], table])
        store[uri] = table
        Path(uri).mkdir(parents=True, exist_ok=True)

    def dataset(uri):
        return SimpleNamespace(to_table=lambda: store[str(uri)])

    mod.write_dataset = write_dataset
    mod.dataset = dataset
    mod._store = store
    monkeypatch.setitem(sys.modules, "lance", mod)
    return mod


@pytest.fixture
def no_lance(monkeypatch):
    monkeypatch.setitem(sys.modules, "lance", None)  # import -> ImportError


def corpus(seed: int, n_clusters: int = 4, per: int = 20, dim: int = DIM):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    vecs = np.concatenate([c + 0.05 * rng.standard_normal((per, dim)) for c in centres]).astype(np.float32)
    return [f"c{i}" for i in range(len(vecs))], vecs


def rel_fragments(store, subdir: str) -> list[str]:
    return [rel for rel, _size in store.fragment_info(subdir)]


def assert_hits_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert [h for h, _ in g] == [h for h, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=ATOL)


# -- backend resolution ---------------------------------------------------------


def test_lance_is_the_default_where_it_imports(tmp_path, fake_lance):
    t, j = tstore.IndexStore(str(tmp_path / "t")), jstore.IndexStore(str(tmp_path / "j"))
    assert t.backend == j.backend == "lance"
    assert t._fragment_path("pending", "x").endswith("/pending/x.lance")


@pytest.mark.parametrize("backend", [None, "lance", "parquet"])
def test_without_lance_both_fall_back_with_one_warning(backend, tmp_path, no_lance, monkeypatch):
    warned = {}
    for name, mod in (("torch", tstore), ("jax", jstore)):
        seen = warned.setdefault(name, [])
        monkeypatch.setattr(mod.logger, "warning", lambda msg, *a, seen=seen: seen.append(msg % a))
    t = tstore.IndexStore(str(tmp_path / "idx"), backend=backend)
    j = jstore.IndexStore(str(tmp_path / "idx"), backend=backend)
    assert t.backend == j.backend == "parquet"
    assert warned["torch"] == warned["jax"] == (
        [f"lance backend unavailable for {tmp_path / 'idx'}; falling back to parquet"] if backend == "lance" else [])


@pytest.mark.parametrize("pinned", ["parquet", "lance"])
def test_meta_pins_the_backend(pinned, tmp_path, fake_lance):
    """A saved ``meta.json`` decides the backend of every later open,
    whatever imports; an explicit argument still wins."""
    tstore.IndexStore(str(tmp_path / "t"), backend=pinned).save_meta({"version": 1})
    jstore.IndexStore(str(tmp_path / "j"), backend=pinned).save_meta({"version": 1})
    assert (tmp_path / "t" / "meta.json").read_bytes() == (tmp_path / "j" / "meta.json").read_bytes()
    assert tstore.IndexStore(str(tmp_path / "t")).backend == jstore.IndexStore(str(tmp_path / "j")).backend == pinned
    other = {"lance": "parquet", "parquet": "lance"}[pinned]
    assert tstore.IndexStore(str(tmp_path / "t"), backend=other).backend == other


# -- fragment IO ------------------------------------------------------------------


def test_pending_roundtrip(tmp_path, fake_lance):
    ids, vecs = corpus(0)
    out = {}
    for name, mod in (("t", tstore), ("j", jstore)):
        store = mod.IndexStore(str(tmp_path / name))
        path = store.write_pending_fragment("chunk-00000", ids[:5], vecs[:5] * 2, model="m", provenance="p")
        store.write_pending_fragment("chunk-00001", ids[5:9], vecs[5:9], model="m", provenance="q")
        assert path == str(tmp_path / name / "pending" / "chunk-00000.lance") and Path(path).is_dir()
        out[name] = (store.list_pending(), store.read_pending(), rel_fragments(store, "pending"))
    (t_paths, t_rows, t_rel), (j_paths, j_rows, j_rel) = out["t"], out["j"]
    assert [Path(p).name for p in t_paths] == [Path(p).name for p in j_paths] == ["chunk-00000.lance",
                                                                                    "chunk-00001.lance"]
    assert t_rel == j_rel
    assert t_rows[0] == j_rows[0] == ids[:9] and t_rows[2:] == j_rows[2:]
    np.testing.assert_allclose(t_rows[1], j_rows[1], atol=ATOL)
    np.testing.assert_allclose(t_rows[1], jstore.normalize_rows(np.concatenate([vecs[:5] * 2, vecs[5:9]])), atol=ATOL)
    t, j = tstore.IndexStore(str(tmp_path / "t")), jstore.IndexStore(str(tmp_path / "j"))
    assert t.clear_pending() == j.clear_pending() == 2
    assert t.list_pending() == j.list_pending() == []


def test_the_table_handed_to_lance_is_the_references(tmp_path, fake_lance):
    ids, vecs = corpus(1)
    tstore.IndexStore(str(tmp_path / "t")).append_cluster(3, ids[:7], vecs[:7])
    jstore.IndexStore(str(tmp_path / "j")).append_cluster(3, ids[:7], vecs[:7])
    tables = {}
    for uri, table in fake_lance._store.items():
        rel = Path(uri).relative_to(tmp_path)
        tables[rel.parts[0]] = (Path(*rel.parts[1:]), table)
    (t_rel, t_table), (j_rel, j_table) = tables["t"], tables["j"]
    assert t_rel == j_rel and str(t_rel).startswith("clusters/c00003/") and str(t_rel).endswith(".lance")
    assert t_table.schema.equals(j_table.schema)
    assert t_table.column("clip_uuid").to_pylist() == j_table.column("clip_uuid").to_pylist()
    assert t_table.column("embedding").to_pylist() == j_table.column("embedding").to_pylist()


def test_clusters_counts_and_deletes(tmp_path, fake_lance):
    ids, vecs = corpus(2)
    stores = {"t": tstore.IndexStore(str(tmp_path / "t")), "j": jstore.IndexStore(str(tmp_path / "j"))}
    for store in stores.values():
        store.append_cluster(0, ids[:4], vecs[:4])
        store.append_cluster(0, ids[4:6], vecs[4:6])
        store.append_cluster(12, ids[6:9], vecs[6:9])
        (Path(store.root) / "clusters" / "junk").mkdir()
    t, j = stores["t"], stores["j"]
    assert t.cluster_fragment_counts() == j.cluster_fragment_counts() == {0: 2, 12: 1}
    for cid in (0, 12, 5):
        (ti, tv), (ji, jv) = t.read_cluster(cid), j.read_cluster(cid)
        assert ti == ji
        np.testing.assert_allclose(tv, jv, atol=ATOL)
    assert t.fragment_info("clusters/c00000") == j.fragment_info("clusters/c00000")
    assert t.build_live_manifest()["clusters"] == j.build_live_manifest()["clusters"]
    rels = rel_fragments(t, "clusters/c00000")[:1] + ["clusters/c00009/gone.lance"]
    assert t.delete_fragments(rels) == j.delete_fragments(rels) == 2
    assert t.cluster_fragment_counts() == j.cluster_fragment_counts() == {0: 1, 12: 1}


# -- the corpus index on lance ------------------------------------------------------


def both_built(tmp_path, ids, vecs, **kw):
    j = jci.CorpusIndex.build(str(tmp_path / "j"), ids, vecs, backend="lance", **kw)
    t = tci.CorpusIndex.build(str(tmp_path / "t"), ids, vecs, backend="lance", device="cpu", **kw)
    return t, j


def test_build_add_query_reopen(tmp_path, fake_lance, jax_first):
    ids, vecs = corpus(3)
    t, j = both_built(tmp_path, ids, vecs, model="m", k=4)
    assert t.store.backend == j.store.backend == "lance"
    assert t.meta == j.meta and t.meta["backend"] == "lance"
    np.testing.assert_allclose(t.centroids, j.centroids, atol=1e-5)
    assert t.store.cluster_fragment_counts() == j.store.cluster_fragment_counts()
    # fresh rows: a near-copy of an indexed row would tie with it within
    # fp32 rounding, and the two packages sum the products in other orders
    new = np.random.default_rng(9).standard_normal((3, DIM)).astype(np.float32)
    t.add(["n0", "n1", "n2"], new)
    j.add(["n0", "n1", "n2"], new)
    t2, j2 = tci.CorpusIndex.open(str(tmp_path / "t"), device="cpu"), jci.CorpusIndex.open(str(tmp_path / "j"))
    assert t2.store.backend == "lance" and t2.meta == j2.meta and t2.meta["num_vectors"] == len(ids) + 3
    queries = (vecs[::5] + 0.01 * np.random.default_rng(4).standard_normal((len(vecs[::5]), DIM))).astype(np.float32)
    for top_k, nprobe in ((2, 1), (5, 2)):
        assert_hits_equal(t2.query(queries, top_k=top_k, nprobe=nprobe), j2.query(queries, top_k=top_k, nprobe=nprobe))
    assert [row[0][0] for row in t2.query(new, top_k=2)] == ["n0", "n1", "n2"]


def test_incremental_dedup_and_consolidation(tmp_path, fake_lance, jax_first, monkeypatch):
    monkeypatch.setenv(tstore.ALLOW_RANDOM_ENV, "1")
    ids, vecs = corpus(5)
    t, j = both_built(tmp_path, ids[:60], vecs[:60], model="m", k=3)
    fresh = np.random.default_rng(6).standard_normal((4, DIM)).astype(np.float32)
    batch = np.concatenate([vecs[:3] + 1e-6, fresh, fresh[:1] + 1e-6]).astype(np.float32)
    batch_ids = [f"b{i}" for i in range(len(batch))]
    got = tci.incremental_dedup(t, batch_ids, batch, eps=1e-3)
    want = jci.incremental_dedup(j, batch_ids, batch, eps=1e-3)
    assert got == want
    for name, mod in (("t", tstore), ("j", jstore)):
        mod.IndexStore(str(tmp_path / name)).write_pending_fragment("chunk-00000", ids[60:], vecs[60:], model="m",
                                                                    provenance="checkpoint:ab")
    t_res = tci.consolidate_index(str(tmp_path / "t"), device="cpu")
    j_res = jci.consolidate_index(str(tmp_path / "j"))
    assert {k: v for k, v in t_res.items() if not k.endswith("_s")} == {
        k: v for k, v in j_res.items() if not k.endswith("_s")}
    assert t_res["consolidated"] == len(ids) - 60
    assert tstore.IndexStore(str(tmp_path / "t")).list_pending() == []
    assert_hits_equal(tci.CorpusIndex.open(str(tmp_path / "t"), device="cpu").query(vecs[::9], top_k=3),
                      jci.CorpusIndex.open(str(tmp_path / "j")).query(vecs[::9], top_k=3))


def test_compact_index_folds_and_publishes(tmp_path, fake_lance, jax_first):
    ids, vecs = corpus(7)
    both_built(tmp_path, ids, vecs, model="m", k=4)
    new = np.random.default_rng(8).standard_normal((6, DIM)).astype(np.float32)
    new_ids = [f"n{i}" for i in range(6)]
    for name, mod in (("t", tstore), ("j", jstore)):
        store = mod.IndexStore(str(tmp_path / name))
        store.write_pending_fragment("t0", new_ids, new, model="m", provenance="checkpoint:ab")
        store.write_pending_fragment("t1", new_ids, new, model="m", provenance="checkpoint:ab")  # a re-run
    got = tcomp.compact_index(str(tmp_path / "t"), device="cpu")
    want = jcomp.compact_index(str(tmp_path / "j"))
    assert {k: v for k, v in got.items() if k != "index_path" and not k.endswith("_s")} == {
        k: v for k, v in want.items() if k != "index_path" and not k.endswith("_s")}
    assert got["published"] and got["generation"] == 1 and got["folded"] == 6
    t, j = tstore.IndexStore(str(tmp_path / "t")), jstore.IndexStore(str(tmp_path / "j"))
    assert t.backend == j.backend == "lance"
    tm, jm = t.read_manifest(), j.read_manifest()
    assert tm["clusters"].keys() == jm["clusters"].keys()
    for cid, info in tm["clusters"].items():
        assert info["fragments"] == jm["clusters"][cid]["fragments"] and info["rows"] == jm["clusters"][cid]["rows"]
        assert all(f.endswith(".lance") for f in info["fragments"])
        assert t.read_fragments(info["fragments"])[0] == j.read_fragments(jm["clusters"][cid]["fragments"])[0]
    assert t.list_pending() == j.list_pending() == []
    index = tci.CorpusIndex.open(str(tmp_path / "t"), device="cpu")
    assert [h[0][0] for h in index.query(new, top_k=1)] == new_ids


def test_run_dedup_reclusters_when_the_index_does_not_open(tmp_path, monkeypatch):
    """An index that does not open (here its lance datasets are gone from
    under a lance-pinned meta) makes ``run_dedup`` recluster, as the
    reference does, whatever the error."""
    from cosmos_curate_tpu_torch.pipelines.video import dedup as tdedup

    calls = []

    def broken_open(root, **kw):
        calls.append(root)
        raise KeyError("centroids")

    monkeypatch.setattr(tci.CorpusIndex, "exists", staticmethod(lambda root: True))
    monkeypatch.setattr(tci.CorpusIndex, "open", staticmethod(broken_open))
    args = tdedup.DedupPipelineArgs(input_path=str(tmp_path / "run"), device="cpu")
    assert tdedup._open_index(args, "cpu", "m") is None
    assert calls == [str(tmp_path / "run" / "index")]


# -- the parquet to lance export -------------------------------------------------------


def write_run_output(root: Path, models=(("internvideo2-1b-tpu", 2, 3),), dim: int = 4) -> Path:
    rng = np.random.default_rng(0)
    for model, chunks, rows in models:
        d = root / "embeddings" / model
        d.mkdir(parents=True)
        for c in range(chunks):
            write_parquet(str(d / f"chunk-{c}.parquet"),
                          {"clip_uuid": [f"c{c}-{i}" for i in range(rows)],
                           "embedding": [rng.normal(size=dim).astype(np.float32) for _ in range(rows)]})
    return root / "embeddings"


@pytest.mark.parametrize("where", ["embeddings", "one_model", "two_models"])
def test_load_embedding_tables_matches(where, tmp_path):
    models = (("internvideo2-1b-tpu", 2, 3), ("clip-vit-b16-tpu", 3, 2)) if where == "two_models" else \
        (("internvideo2-1b-tpu", 2, 3),)
    src = write_run_output(tmp_path, models)
    if where == "one_model":
        src = src / "internvideo2-1b-tpu"
    got, want = texport.load_embedding_tables(src), jexport.load_embedding_tables(src)
    assert list(got) == list(want)
    for model in want:
        assert got[model].equals(want[model])
        assert got[model].column_names == ["clip_uuid", "embedding"]
    assert sum(t.num_rows for t in got.values()) == sum(c * r for _, c, r in models)


def test_export_without_lance_raises_the_guidance(tmp_path, no_lance):
    src = write_run_output(tmp_path)
    errors = []
    for mod in (texport, jexport):
        with pytest.raises(RuntimeError, match="pip install pylance") as e:
            mod.export_parquet_to_lance(src, tmp_path / "out")
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("mode", ["create", "overwrite", "append"])
def test_export_calls_write_dataset_like_the_reference(mode, tmp_path, monkeypatch):
    src = write_run_output(tmp_path, (("internvideo2-1b-tpu", 2, 3), ("clip-vit-b16-tpu", 1, 4)))
    calls = []
    fake = types.ModuleType("lance")
    fake.write_dataset = lambda table, uri, mode: calls.append((table, uri, mode))
    monkeypatch.setitem(sys.modules, "lance", fake)
    got = texport.export_parquet_to_lance(src, tmp_path / "out", mode=mode)
    want = jexport.export_parquet_to_lance(src, tmp_path / "out", mode=mode)
    assert got == want == {str(tmp_path / "out" / "clip-vit-b16-tpu.lance"): 4,
                           str(tmp_path / "out" / "internvideo2-1b-tpu.lance"): 6}
    t_calls, j_calls = calls[:2], calls[2:]
    assert [(u, m) for _, u, m in t_calls] == [(u, m) for _, u, m in j_calls]
    assert all(a.equals(b) for (a, _, _), (b, _, _) in zip(t_calls, j_calls, strict=True))


def test_export_of_an_empty_source_raises(tmp_path):
    (tmp_path / "embeddings").mkdir()
    for mod in (texport, jexport):
        with pytest.raises(FileNotFoundError, match="no embeddings parquet found"):
            mod.export_parquet_to_lance(tmp_path / "embeddings", tmp_path / "out")
