"""Port parity: k-means, semantic dedup and the dedup pipeline.

The JAX package draws k-means' first seed centroid with
``jax.random.choice``, which a torch generator cannot reproduce; the port
draws it from a seeded ``torch.Generator`` (``_first_index``). These tests
give the port the index JAX drew (``jax.random.choice`` called as the JAX
seeding calls it, or read back from the JAX centroids where a mesh pads
the rows), and then everything must match: the seeding and Lloyd steps'
centroids (fp32, atol 1e-5) and assignments (exact), the kept set, the
removed set and ``duplicate_of`` (exact), the dedup CSV rows in order and
``summary.json`` apart from ``elapsed_s``.

The data are planted clusters with planted near-duplicates (cosine above
``1 - eps``), far from any near-tie.
"""

import csv
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cosmos_curate_tpu.dedup import kmeans as jk
from cosmos_curate_tpu.pipelines.video import dedup as jdedup
from cosmos_curate_tpu.storage.writers import write_parquet as jwrite_parquet
from cosmos_curate_tpu_torch.dedup import kmeans as tk
from cosmos_curate_tpu_torch.pipelines.video import dedup as tdedup

CENT_ATOL = 1e-5


def planted(seed: int, n_clusters: int, per_cluster: int, dim: int, dup_every: int = 3):
    """Unit-ish rows around ``n_clusters`` centres; every ``dup_every``-th
    row is a near-copy (cosine > 0.999) of the row before it. Returns the
    rows and, for each near-copy, the index of its original."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    rows, dup_of = [], {}
    for c in range(n_clusters):
        for i in range(per_cluster):
            if i % dup_every == dup_every - 1:
                dup_of[len(rows)] = len(rows) - 1
                rows.append(rows[-1] + 1e-3 * rng.standard_normal(dim).astype(np.float32))
            else:
                rows.append(centres[c] + 0.6 * rng.standard_normal(dim).astype(np.float32))
    return np.stack(rows).astype(np.float32), dup_of


def jax_first_index(n: int, seed: int) -> int:
    """The row the JAX seeding starts from, drawn as ``_init_centroids``
    draws it (inside a jit, over all-valid rows)."""
    def draw(key):
        mask = jnp.arange(n) < n
        return jax.random.choice(key, n, p=mask / jnp.maximum(mask.sum(), 1))

    return int(jax.jit(draw)(jax.random.PRNGKey(seed)))


@pytest.fixture
def jax_first(monkeypatch):
    """The port's first pick replaced by the JAX draw."""
    monkeypatch.setattr(tk, "_first_index", lambda valid, seed: jax_first_index(valid, seed))


def test_first_index_is_a_seeded_uniform_draw():
    picks = {tk._first_index(1000, seed) for seed in range(50)}
    assert all(0 <= p < 1000 for p in picks) and len(picks) > 40
    assert tk._first_index(1000, 7) == tk._first_index(1000, 7)


@pytest.mark.parametrize("k", [1, 6, 17])
def test_init_centroids_match_jax_from_the_same_first_index(k):
    x, _ = planted(0, 6, 30, 24)
    data = tk.normalize_rows(x)
    want = np.asarray(jk._init_centroids(jnp.asarray(data), k, 3, len(data)))
    first = jax_first_index(len(data), 3)
    np.testing.assert_array_equal(want[0], data[first])
    got = tk._init_centroids(torch.from_numpy(data), k, first, len(data)).numpy()
    np.testing.assert_allclose(got, want, atol=CENT_ATOL)
    # rows at or beyond `valid` are never picked after the first
    part = tk._init_centroids(torch.from_numpy(data), k, 7, 100).numpy()
    picked = [int(np.argmin(np.abs(data - c).sum(1))) for c in part]
    assert picked[0] == 7 and max(picked) < 100


@pytest.mark.parametrize("valid", [180, 150])
def test_lloyd_step_matches_jax(valid):
    x, _ = planted(1, 6, 30, 24)
    data = tk.normalize_rows(x)
    cents = np.array(jk._init_centroids(jnp.asarray(data), 8, 0, valid))
    want_new, want_assign, want_shift = jk._lloyd_step(jnp.asarray(data), jnp.asarray(cents), valid)
    new, assign, shift = tk._lloyd_step(torch.from_numpy(data), torch.from_numpy(cents), valid)
    np.testing.assert_allclose(new.numpy(), np.asarray(want_new), atol=CENT_ATOL)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(want_assign))
    assert abs(float(shift) - float(want_shift)) <= CENT_ATOL


@pytest.mark.parametrize("k,iters", [(6, 20), (9, 3), (24, 5)])
def test_kmeans_fit_matches_jax(k, iters, jax_first):
    x, _ = planted(2, 6, 40, 32)
    want_c, want_a = jk.kmeans_fit(x, k, iters=iters, seed=5)
    got_c, got_a = tk.kmeans_fit(x, k, iters=iters, seed=5, device="cpu")
    assert got_c.shape == want_c.shape == (min(k, len(x)), 32)
    np.testing.assert_allclose(got_c, want_c, atol=CENT_ATOL)
    np.testing.assert_array_equal(got_a, np.asarray(want_a))


@pytest.mark.parametrize("n_clusters,eps", [(None, 0.07), (4, 0.07), (12, 0.2)])
def test_semantic_dedup_matches_jax(n_clusters, eps, jax_first):
    x, dup_of = planted(3, 8, 36, 48)
    ids = [f"clip-{i:04d}" for i in range(len(x))]
    want = jk.semantic_dedup(x, ids, n_clusters=n_clusters, eps=eps, seed=2)
    got = tk.semantic_dedup(x, ids, n_clusters=n_clusters, eps=eps, seed=2, device="cpu")
    assert got["kept"] == want["kept"] and got["removed"] == want["removed"]
    assert got["duplicate_of"] == want["duplicate_of"]
    np.testing.assert_array_equal(got["assignments"], np.asarray(want["assignments"]))
    if eps == 0.07:  # the planted near-copies, and nothing else, go
        assert got["duplicate_of"] == {ids[i]: ids[j] for i, j in dup_of.items()}
    assert set(got["kept"]) | set(got["removed"]) == set(ids)
    assert set(got["duplicate_of"].values()) <= set(got["kept"])


def test_empty_input_matches_jax():
    want = jk.semantic_dedup(np.zeros((0, 8), np.float32), [])
    got = tk.semantic_dedup(np.zeros((0, 8), np.float32), [], device="cpu")
    assert {k: v for k, v in got.items() if k != "assignments"} == {
        k: v for k, v in want.items() if k != "assignments"}
    assert got["assignments"].shape == want["assignments"].shape == (0,)


def test_dedup_args_mirror_the_reference_field_for_field():
    t_fields = {f.name: f.default for f in dataclasses.fields(tdedup.DedupPipelineArgs)}
    assert t_fields.pop("device") == "cuda"
    assert t_fields == {f.name: f.default for f in dataclasses.fields(jdedup.DedupPipelineArgs)}
    assert tdedup.FETCH_THREADS_ENV == jdedup.FETCH_THREADS_ENV


def write_split_embeddings(root, x: np.ndarray, ids: list[str], model: str = "video-embed-tpu", chunks: int = 3,
                           other: bool = True):
    """A split output's ``embeddings/<model>/`` parquets, in ``chunks`` files,
    and (``other``) one parquet of another model that dedup leaves out."""
    bounds = np.linspace(0, len(ids), chunks + 1).astype(int)
    for c, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        jwrite_parquet(f"{root}/embeddings/{model}/{c:04d}-00000.parquet",
                       {"clip_uuid": ids[lo:hi], "embedding": [r.tolist() for r in x[lo:hi]]})
    if other:
        jwrite_parquet(f"{root}/embeddings/{model}-other/0000-00000.parquet",
                       {"clip_uuid": ids[:2], "embedding": [[0.0, 1.0], [1.0, 0.0]]})


def record_jax_picks(monkeypatch) -> list[np.ndarray]:
    """Record the first row of every JAX k-means seeding from now on (under
    the test mesh the JAX rows are padded, so the draw is read back from the
    centroids)."""
    picks: list[np.ndarray] = []
    init = jk._init_centroids

    def recording(data, k, seed, valid):
        cents = init(data, k, seed, valid)
        picks.append(np.asarray(cents)[0])
        return cents

    monkeypatch.setattr(jk, "_init_centroids", recording)
    return picks


def port_first_from(monkeypatch, picks: list[np.ndarray], x: np.ndarray) -> None:
    """The port's first pick replaced by the row of ``x`` that the last JAX
    seeding started from."""
    data = tk.normalize_rows(x)
    monkeypatch.setattr(tk, "_first_index", lambda valid, seed: int(np.argmin(np.abs(data - picks[-1]).sum(1))))


@pytest.fixture
def jax_picks(monkeypatch):
    return record_jax_picks(monkeypatch)


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("eps,n_clusters,threads", [(0.07, 0, "4"), (0.15, 5, "1")])
def test_run_dedup_matches_jax(eps, n_clusters, threads, tmp_path, jax_picks, monkeypatch):
    x, dup_of = planted(4, 6, 33, 64)
    ids = [f"{i:08x}-clip" for i in range(len(x))]
    write_split_embeddings(tmp_path / "split", x, ids)
    monkeypatch.setenv(tdedup.FETCH_THREADS_ENV, threads)
    kw = dict(input_path=str(tmp_path / "split"), eps=eps, n_clusters=n_clusters)
    want = jdedup.run_dedup(jdedup.DedupPipelineArgs(output_path=str(tmp_path / "jax"), **kw))
    port_first_from(monkeypatch, jax_picks, x)
    got = tdedup.run_dedup(tdedup.DedupPipelineArgs(output_path=str(tmp_path / "port"), device="cpu", **kw))
    assert got.pop("elapsed_s") >= 0 and want.pop("elapsed_s") >= 0
    assert got == want
    assert got["num_embeddings"] == len(ids) and got["embedding_model"] == "video-embed-tpu"
    name = f"dedup_summary_{eps:g}.csv"
    rows, j_rows = _csv_rows(tmp_path / "port" / name), _csv_rows(tmp_path / "jax" / name)
    assert rows == j_rows
    assert [r["action"] for r in rows] == ["removed"] * got["num_removed"] + ["kept"] * got["num_kept"]
    if eps == 0.07:
        assert {r["clip_uuid"] for r in rows if r["action"] == "removed"} == {ids[i] for i in dup_of}
    summary = json.loads((tmp_path / "port" / "summary.json").read_text())
    j_summary = json.loads((tmp_path / "jax" / "summary.json").read_text())
    assert summary.pop("elapsed_s") >= 0 and j_summary.pop("elapsed_s") >= 0
    assert summary == j_summary


def test_run_dedup_writes_under_the_input_by_default(tmp_path, jax_picks, monkeypatch):
    x, _ = planted(5, 3, 12, 16)
    ids = [f"c{i}" for i in range(len(x))]
    write_split_embeddings(tmp_path, x, ids, model="clip-vit-b16-tpu", chunks=1)
    want = jdedup.run_dedup(jdedup.DedupPipelineArgs(input_path=str(tmp_path), embedding_model="clip-vit-b16-tpu",
                                                     use_mesh=False))
    j_rows = _csv_rows(tmp_path / "dedup" / "dedup_summary_0.07.csv")
    port_first_from(monkeypatch, jax_picks, x)
    got = tdedup.run_dedup(tdedup.DedupPipelineArgs(input_path=str(tmp_path), embedding_model="clip-vit-b16-tpu",
                                                    use_mesh=False, device="cpu"))
    assert _csv_rows(tmp_path / "dedup" / "dedup_summary_0.07.csv") == j_rows
    assert {k: v for k, v in got.items() if k != "elapsed_s"} == {k: v for k, v in want.items() if k != "elapsed_s"}


def test_no_embeddings_raise_like_jax(tmp_path):
    (tmp_path / "embeddings").mkdir()
    with pytest.raises(FileNotFoundError, match="no embedding parquets"):
        jdedup.load_embeddings(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no embedding parquets"):
        tdedup.run_dedup(tdedup.DedupPipelineArgs(input_path=str(tmp_path), device="cpu"))
    write_split_embeddings(tmp_path, np.ones((3, 4), np.float32), ["a", "b", "c"])
    with pytest.raises(FileNotFoundError):
        tdedup.load_embeddings(str(tmp_path), "no-such-model")


@pytest.mark.parametrize("model", ["", "video-embed-tpu-other"])
def test_load_embeddings_matches_jax(model, tmp_path):
    x, _ = planted(7, 2, 9, 2)
    ids = [f"c{i}" for i in range(len(x))]
    write_split_embeddings(tmp_path, x, ids)
    j_ids, j_x, j_model = jdedup.load_embeddings(str(tmp_path), model)
    t_ids, t_x, t_model = tdedup.load_embeddings(str(tmp_path), model)
    assert (t_ids, t_model) == (j_ids, j_model)
    np.testing.assert_array_equal(t_x, j_x)
    assert t_x.dtype == np.float32
