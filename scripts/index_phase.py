"""``chip_smoke.py``'s corpus-index phases, which ``chip_smoke.py`` runs after
its curate phases, or alone on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/index_phase.py

Alone, it builds the kernels, checks flash at ``chip_smoke.FLASH_CASES`` and
writes the first ``INDEX_SPLIT_VIDEOS`` videos of the split corpus. Both
phases set ``CURATE_INDEX_ALLOW_RANDOM=1`` themselves (every model here has
seeded weights, so the provenance gates would refuse everything) after one
check that the gates do refuse without it. One JSON line per phase:

- ``index``: a corpus of ``INDEX_N`` x ``INDEX_DIM`` fp32 rows around
  ``INDEX_K`` planted centres (``curate_phase.planted_rows``).
  ``CorpusIndex.build`` (k-means on the card, shard writes on the host);
  ``incremental_dedup`` of ``INDEX_QUERIES`` queries at nprobe
  ``INDEX_NPROBE``: near-copies of indexed rows (cosine distance below
  eps / 4) and fresh rows, of which exactly the copies must go, each
  ``duplicate_of`` its source; the same batch's query wall split into host
  routing, shard loads, the device top-k (CUDA events) and the host merge,
  and the device's idle share under the profiler; recall@8 against an
  exact top-8 over all rows on the card (>= ``RECALL_BAR``); then an
  ``IndexServer`` on the card answers ``SERVER_REQUESTS`` concurrent
  requests (clip rows, indexed uuids and ``SERVER_TEXTS`` texts through
  ``clip-text-b-tpu``, the flash kernel's causal branch): every request
  answered, each answer equal to ``CorpusIndex.query`` on the same rows
  (ids in order, similarities within ``ANSWER_ATOL``, a near-tie within it
  may swap), queries/s and p50 / p99 latency, flash launches and every
  flash shape checked against the plain version; then ``compact_index``
  folds ``PENDING_ROWS`` pending rows while queries are in flight: every
  answer from generation 0 or the new one, the server adopts the new one,
  recall@8 still >= ``RECALL_BAR``.
- ``index_split`` (run E): the first ``INDEX_SPLIT_VIDEOS`` corpus videos
  through ``run_split`` with ``clip`` embeddings and ``corpus_index=True``
  (the summary's ``corpus_index`` block with every clip consolidated), the
  same videos under new names through a second ``run_split`` with
  ``incremental_dedup="enable"`` against that index (every clip removed,
  ``filtered_by == "dedup"``), and ``run_dedup`` on the first output
  (``method == "index_query"``).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

# 2^16 rows: the parquet IO of the reference's list<double> shards bounds
# every step of the phase (build, cold dedup, server warm-up, compaction);
# at 2^18 the phase took ~120 s of the full call's 1200 s limit, and 2^17
# (~67 s) became too much once the engine phase joined the call
INDEX_N = 1 << 16
INDEX_DIM = 512  # clip-text-b-tpu's projection and the `clip` embedding's width
INDEX_K = 512  # 128 rows a cluster
INDEX_NPROBE = 8
INDEX_TOP_K = 8
INDEX_QUERIES = 1024  # half near-copies of indexed rows, half fresh rows
DEDUP_EPS = 0.07
COPY_NOISE = 0.05  # a copy's noise over its row's norm: cosine distance ~1.3e-3, below eps / 4
RECALL_BAR = 0.95  # the JAX package's bar (tests/dedup/test_index_server.py)
SERVER_REQUESTS = 256
SERVER_TEXTS = 64
SERVER_UUIDS = 64
ANSWER_ATOL = 1e-5
PENDING_ROWS = 4096
HAMMER_THREADS = 4
# the index's shards held in host memory whole (the corpus is ~0.53 GB of
# fp32 rows and ids): a serving deployment sizes its cache to its probe
# union, and the default 256 MB would re-read every shard per batch
CACHE_BYTES = 2 << 30
INDEX_SPLIT_VIDEOS = 8
WORDS = ("a red car drives down a wet city street at night while people cross under bright shop lights and a dog "
         "runs past an old stone bridge over the river").split()


def texts_of(rng, n: int) -> list[str]:
    """``n`` distinct word strings (each ends in its own number)."""
    return [" ".join([*(WORDS[int(i)] for i in rng.integers(len(WORDS), size=int(rng.integers(3, 16)))), str(j)])
            for j in range(n)]


@contextlib.contextmanager
def allow_random(value: str | None):
    """``CURATE_INDEX_ALLOW_RANDOM`` set to ``value`` (None: unset) for the
    block, restored after."""
    from cosmos_curate_tpu_torch.dedup.index_store import ALLOW_RANDOM_ENV

    saved = os.environ.get(ALLOW_RANDOM_ENV)
    if value is None:
        os.environ.pop(ALLOW_RANDOM_ENV, None)
    else:
        os.environ[ALLOW_RANDOM_ENV] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(ALLOW_RANDOM_ENV, None)
        else:
            os.environ[ALLOW_RANDOM_ENV] = saved


@contextlib.contextmanager
def wrapped(owner, name: str, around):
    """``owner.name`` replaced for the block by ``around(original)``."""
    saved = getattr(owner, name)
    setattr(owner, name, around(saved))
    try:
        yield
    finally:
        setattr(owner, name, saved)


def host_timed(times: dict, key: str):
    def around(fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                times[key] = times.get(key, 0.0) + time.perf_counter() - t0
        return timed
    return around


@contextlib.contextmanager
def query_parts(times: dict):
    """The query path's wall split, summed in ``times``: host routing,
    shard loads, the device top-k (host wall, and its CUDA-event span in
    ``topk_device_s``) and the host merge (``score_shards`` less the
    top-k)."""
    from cosmos_curate_tpu_torch.dedup import corpus_index as ci

    def device_timed(fn):
        def timed(self, q, jobs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn(self, q, jobs)  # reads its results back: the device is done
            end.record()
            end.synchronize()
            times["topk_s"] = times.get("topk_s", 0.0) + time.perf_counter() - t0
            times["topk_device_s"] = times.get("topk_device_s", 0.0) + start.elapsed_time(end) / 1e3
            times["topk_jobs"] = times.get("topk_jobs", 0) + len(jobs)
            return out
        return timed

    with (wrapped(ci, "route_queries", host_timed(times, "routing_s")),
          wrapped(ci.CorpusIndex, "_load_cluster", host_timed(times, "shard_loads_s")),
          wrapped(ci, "score_shards", host_timed(times, "score_shards_s")),
          wrapped(ci.DeviceTopK, "__call__", device_timed)):
        yield


def exact_topk(dev, corpus: torch.Tensor, q: np.ndarray, k: int) -> np.ndarray:
    """Row indices of each query's exact top-``k`` over every corpus row,
    in fp32 on the card (TF32 off)."""
    from cosmos_curate_tpu_torch.dedup.kmeans import _fp32

    with torch.inference_mode(), _fp32(dev):
        qd = torch.nn.functional.normalize(torch.from_numpy(q).to(dev), dim=1)
        return torch.topk(qd @ corpus.T, k, dim=1).indices.cpu().numpy()


def recall(hits: list, exact: np.ndarray, ids: list[str]) -> float:
    k = exact.shape[1]
    return float(np.mean([len({h for h, _ in row[:k]} & {ids[j] for j in ex}) / k for row, ex in zip(hits, exact,
                                                                                                       strict=True)]))


def same_answer(got: list, want: list, atol: float = ANSWER_ATOL) -> bool:
    """Equal hit lists: the same length, similarities within ``atol``
    position by position, and the same ids, except that a near-tie (two
    hits within ``atol``) may swap or, at the last place, differ."""
    if len(got) != len(want):
        return False
    g_sims, w_sims = np.array([s for _, s in got]), np.array([s for _, s in want])
    if len(got) and not np.allclose(g_sims, w_sims, rtol=0, atol=atol):
        return False
    w_sim_of = dict(want)
    for i, ((g_id, g_sim), (w_id, _w_sim)) in enumerate(zip(got, want, strict=True)):
        if g_id == w_id:
            continue
        if g_id in w_sim_of and abs(w_sim_of[g_id] - g_sim) <= atol:
            continue
        if i == len(got) - 1:
            continue  # the last place: the other list's hit ties within atol (sims checked above)
        return False
    return True


def index_corpus(cs, dev):
    """(ids, rows [N, D] host fp32, fresh rows [Q/2, D]): planted rows, the
    last ``INDEX_QUERIES // 2`` held out of the index as fresh queries."""
    import curate_phase

    fresh_n = INDEX_QUERIES // 2
    rows, _labels = curate_phase.planted_rows(dev, INDEX_N + fresh_n, INDEX_K, INDEX_DIM, cs.SEED + 41)
    return [f"row-{i:06d}" for i in range(INDEX_N)], rows[:INDEX_N], rows[INDEX_N:]


def planted_copies(rng, x: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(source rows, near-copies): ``n`` distinct indexed rows, each plus
    noise of ``COPY_NOISE`` of its norm."""
    src = rng.choice(len(x), n, replace=False)
    noise = rng.standard_normal((n, x.shape[1])).astype(np.float32)
    noise *= (COPY_NOISE * np.linalg.norm(x[src], axis=1) / np.linalg.norm(noise, axis=1))[:, None]
    return src, (x[src] + noise).astype(np.float32)


def check_gates(root: Path, dev) -> dict:
    """With ``CURATE_INDEX_ALLOW_RANDOM`` unset, the gates refuse the seeded
    models: consolidation skips random-provenance rows, the server refuses
    text queries through the seeded text tower."""
    from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex, consolidate_index
    from cosmos_curate_tpu_torch.dedup.index_server import IndexServer, ProvenanceError
    from cosmos_curate_tpu_torch.dedup.index_store import IndexStore

    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, INDEX_DIM)).astype(np.float32)
    with allow_random(None):
        IndexStore(str(root / "gate")).write_pending_fragment("t0", [f"g{i}" for i in range(16)], x, model="m",
                                                             provenance="random")
        consolidated = consolidate_index(str(root / "gate"), device=dev)
        assert consolidated["skipped_random"] == 16 and consolidated["consolidated"] == 0, consolidated
        assert not CorpusIndex.exists(str(root / "gate"))
        CorpusIndex.build(str(root / "gate"), [f"g{i}" for i in range(16)], x, model="m", k=2, device=dev)
        srv = IndexServer(str(root / "gate"), device=dev, warmup=False)
        try:
            try:
                srv.search(text="a red car")
            except ProvenanceError as e:
                refused = str(e)
            else:
                raise AssertionError("the server served text on seeded weights without the opt-in")
        finally:
            srv.close()
    return {"consolidation_skipped_random": consolidated["skipped_random"], "text_refused": refused[:80]}


def drive_server(cs, timer, srv, index, ids, x, copies, fresh) -> dict:
    """``SERVER_REQUESTS`` concurrent requests through the ``IndexServer``
    ``srv``, each answer held against ``CorpusIndex.query`` on its rows."""
    from cosmos_curate_tpu_torch.dedup.index_server import IndexServer

    rng = np.random.default_rng(cs.SEED + 43)
    texts = texts_of(rng, SERVER_TEXTS)
    uuid_rows = rng.choice(len(ids), SERVER_UUIDS, replace=False)
    n_clip = SERVER_REQUESTS - SERVER_TEXTS - SERVER_UUIDS
    clip_rows = np.concatenate([copies[: n_clip // 2], fresh[: n_clip - n_clip // 2]])
    requests = ([("clip", row, None) for row in clip_rows] + [("uuid", ids[i], i) for i in uuid_rows]
                + [("text", t, None) for t in texts])
    order = rng.permutation(len(requests))
    text_rows: dict[str, np.ndarray] = {}

    def recording(fn):
        def embed(self, batch_texts):
            out = fn(self, batch_texts)
            text_rows.update(zip(batch_texts, out, strict=True))
            return out
        return embed

    results: list = [None] * len(requests)
    latencies: list = [0.0] * len(requests)
    barrier = threading.Barrier(len(requests))

    def one(slot: int) -> None:
        mode, payload, _ = requests[order[slot]]
        barrier.wait(timeout=120)
        t = time.perf_counter()
        if mode == "clip":
            results[slot] = srv.search(payload, top_k=INDEX_TOP_K, nprobe=INDEX_NPROBE)
        elif mode == "uuid":
            results[slot] = srv.search(clip_uuid=payload, top_k=INDEX_TOP_K, nprobe=INDEX_NPROBE)
        else:
            results[slot] = srv.search(text=payload, top_k=INDEX_TOP_K, nprobe=INDEX_NPROBE)
        latencies[slot] = time.perf_counter() - t

    # the text tower's setup (seeded init) outside the measured burst
    srv.search(text="warm up", top_k=INDEX_TOP_K)
    shapes: set = set()
    rss: dict = {}
    kernel_launches: dict = {}
    before = srv.stats()["counts"]
    with (cs.counted_launches(kernel_launches), wrapped(IndexServer, "_text_embeddings", recording),
          cs.recorded_flash_shapes(shapes), cs.peak_rss(rss)):
        threads = [threading.Thread(target=one, args=(s,)) for s in range(len(requests))]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.monotonic() - t0
    launches = kernel_launches["flash"]
    assert not any(t.is_alive() for t in threads), "server: requests still waiting"
    assert all(r is not None and r[0] and all(len(h) == INDEX_TOP_K for h in r[0]) for r in results), \
        "server: a request came back without results"
    counts = {k: v - before[k] for k, v in srv.stats()["counts"].items()}
    # every answer against CorpusIndex.query on the same rows
    rows = []
    for slot in range(len(requests)):
        mode, payload, row = requests[order[slot]]
        rows.append(payload if mode == "clip" else x[row] if mode == "uuid" else text_rows[payload])
    want = index.query(np.stack(rows), top_k=INDEX_TOP_K, nprobe=INDEX_NPROBE)
    got = [r[0][0] for r in results]
    exact_equal = sum(g == w for g, w in zip(got, want, strict=True))
    equal = sum(same_answer(g, w) for g, w in zip(got, want, strict=True))
    assert equal == len(requests), f"server: {len(requests) - equal} answers differ from CorpusIndex.query"
    assert launches > 0, "server: the text tower launched no flash kernel"
    for slot in range(len(requests)):
        mode, payload, _ = requests[order[slot]]
        if mode == "uuid":
            assert got[slot][0][0] == payload, f"server: uuid {payload} is not its own top hit"
    lat_ms = sorted(1e3 * v for v in latencies)
    return dict(
        requests=len(requests), by_mode={"clip": n_clip, "uuid": SERVER_UUIDS, "text": SERVER_TEXTS},
        wall_s=wall, queries_per_s=len(requests) / wall,
        latency_ms={"p50": statistics.median(lat_ms), "p99": lat_ms[int(0.99 * (len(lat_ms) - 1))],
                    "max": lat_ms[-1]},
        batches=counts["batches"], mean_batch=counts["batched_requests"] / max(counts["batches"], 1),
        answers_equal=equal, answers_bit_equal=exact_equal, answer_atol=ANSWER_ATOL,
        launches=kernel_launches, flash_shapes=[[*s, c] for s, c in sorted(shapes)],
        flash_checked_here=cs.check_new_flash_shapes(timer, shapes, cs.SEED + 44), peak_host_rss_bytes=rss["bytes"],
    )


def drive_compaction(cs, dev, srv, root: str, ids, queries, corpus_dev) -> dict:
    """``compact_index`` folds ``PENDING_ROWS`` rows while ``HAMMER_THREADS``
    threads query the server ``srv``; it must adopt the new generation,
    recall@8 after it >= ``RECALL_BAR`` over the grown corpus."""
    import curate_phase

    from cosmos_curate_tpu_torch.dedup.compaction import compact_index
    from cosmos_curate_tpu_torch.dedup.index_store import IndexStore

    new, _ = curate_phase.planted_rows(dev, PENDING_ROWS, INDEX_K, INDEX_DIM, cs.SEED + 45)
    new_ids = [f"new-{i:05d}" for i in range(PENDING_ROWS)]
    store = IndexStore(root)
    for c in range(4):  # four writer chunks
        sl = slice(c * PENDING_ROWS // 4, (c + 1) * PENDING_ROWS // 4)
        store.write_pending_fragment(f"chunk-{c:05d}", new_ids[sl], new[sl], model="m", provenance="random")
    stop = threading.Event()
    observed: list = []
    errors: list = []

    def hammer(tid: int) -> None:
        i = 0
        while not stop.is_set():
            qi = (tid * 131 + i) % len(queries)
            try:
                hits, gen = srv.search(queries[qi], top_k=INDEX_TOP_K, nprobe=INDEX_NPROBE)
            except Exception as e:
                errors.append(e)
                return
            observed.append((gen, hits[0]))
            i += 1

    try:
        threads = [threading.Thread(target=hammer, args=(t,)) for t in range(HAMMER_THREADS)]
        for t in threads:
            t.start()
        t0 = time.monotonic()
        report = compact_index(root, device=dev)
        compact_s = time.monotonic() - t0
        during = len(observed)
        deadline = time.monotonic() + 60
        while srv.generation < report["generation"] and time.monotonic() < deadline:
            time.sleep(0.05)
        adopt_s = time.monotonic() - t0 - compact_s
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors, f"compaction: a query failed: {errors[0]!r}"
        assert report["published"] and report["folded"] == PENDING_ROWS, report
        assert srv.generation == report["generation"], "compaction: the server never adopted the new generation"
        gens = {g for g, _ in observed}
        assert gens <= {0, report["generation"]}, gens
        after, gen = srv.search(queries, top_k=INDEX_TOP_K, nprobe=INDEX_NPROBE)
        assert gen == report["generation"]
        hit, _ = srv.search(new[:1], top_k=1, nprobe=INDEX_NPROBE)
        assert hit[0][0][0] == new_ids[0], "compaction: a folded row is not its own top hit"
    finally:
        stop.set()
    all_ids = ids + new_ids
    grown = torch.cat([corpus_dev, torch.nn.functional.normalize(torch.from_numpy(new).to(dev), dim=1)])
    rec = recall(after, exact_topk(dev, grown, queries, INDEX_TOP_K), all_ids)
    assert rec >= RECALL_BAR, f"compaction: recall@8 {rec} after adoption"
    return dict(
        pending_rows=PENDING_ROWS, compact_s=compact_s, adopt_after_publish_s=adopt_s,
        queries_during_compaction=during, queries_answered=len(observed),
        answered_by_generation={g: sum(1 for o, _ in observed if o == g) for g in sorted(gens)},
        recall_at_8_after=rec, report={k: v for k, v in report.items() if k != "index_path"},
    )


def drive_index(cs, dev, timer) -> dict:
    from cosmos_curate_tpu_torch.dedup import corpus_index as ci
    from cosmos_curate_tpu_torch.dedup.index_server import IndexServer
    from cosmos_curate_tpu_torch.dedup.index_store import IndexStore, normalize_rows

    import curate_phase

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_index-"))
    try:
        out: dict = {"gates_without_opt_in": check_gates(root, dev)}
        with allow_random("1"):
            t0 = time.monotonic()
            ids, x, fresh = index_corpus(cs, dev)
            rows_s = time.monotonic() - t0
            rng = np.random.default_rng(cs.SEED + 42)
            src, copies = planted_copies(rng, x, INDEX_QUERIES // 2)
            queries = np.concatenate([copies, fresh])
            names = [f"copy-{i:04d}" for i in range(len(copies))] + [f"fresh-{i:04d}" for i in range(len(fresh))]
            cos = np.sum(normalize_rows(copies) * normalize_rows(x[src]), axis=1)
            assert float(1.0 - cos.min()) < DEDUP_EPS / 4, "index: a planted copy is too far from its source"

            # build: k-means on the card, shard writes on the host
            build_times: dict = {}
            torch.cuda.reset_peak_memory_stats(dev)
            with (curate_phase.timed_module_calls(ci, ("kmeans_fit",), build_times),
                  wrapped(IndexStore, "append_cluster", host_timed(build_times, "append_cluster_s"))):
                t0 = time.monotonic()
                ci.CorpusIndex.build(str(root / "idx"), ids, x, model="m", k=INDEX_K, device=dev)
                build_s = time.monotonic() - t0
            build_peak = torch.cuda.max_memory_allocated(dev)
            disk = sum(p.stat().st_size for p in (root / "idx").rglob("*") if p.is_file())

            os.environ[ci.CLUSTER_CACHE_BYTES_ENV] = str(CACHE_BYTES)
            index = ci.CorpusIndex.open(str(root / "idx"), device=dev)
            torch.cuda.reset_peak_memory_stats(dev)
            cold: dict = {}
            with query_parts(cold):
                t0 = time.monotonic()
                result = ci.incremental_dedup(index, names, queries, eps=DEDUP_EPS, nprobe=INDEX_NPROBE,
                                              top_k=INDEX_TOP_K)
                dedup_s = time.monotonic() - t0
            copy_names = set(names[: len(copies)])
            assert set(result["removed"]) == copy_names, (
                f"index: removed {len(result['removed'])}, planted {len(copy_names)}, "
                f"{len(set(result['removed']) ^ copy_names)} differ")
            assert all(result["duplicate_of"][names[i]] == ids[s] for i, s in enumerate(src)), "index: duplicate_of"

            warm: dict = {}
            with query_parts(warm):
                t0 = time.monotonic()
                hits = index.query(queries, top_k=INDEX_TOP_K, nprobe=INDEX_NPROBE)
                query_s = time.monotonic() - t0
            query_peak = torch.cuda.max_memory_allocated(dev)
            profiled = cs.profile_window(lambda: index.query(queries, top_k=INDEX_TOP_K, nprobe=INDEX_NPROBE), 2,
                                         "query batch")
            corpus_dev = torch.nn.functional.normalize(torch.from_numpy(x).to(dev), dim=1)
            rec = recall(hits, exact_topk(dev, corpus_dev, queries, INDEX_TOP_K), ids)
            assert rec >= RECALL_BAR, f"index: recall@8 {rec}"

            out.update(
                config={"n": INDEX_N, "dim": INDEX_DIM, "k": INDEX_K, "nprobe": INDEX_NPROBE, "top_k": INDEX_TOP_K,
                        "queries": INDEX_QUERIES, "eps": DEDUP_EPS, "cache_bytes": CACHE_BYTES,
                        "cut": "N = 2^16, a sixteenth of the k-means phase's 2^20: the reference's list<double> "
                               "shards bound every step's IO, and 2^20 x 512 are 4 GB on disk",
                        "allow_random": "set by the phase"},
                rows_made_s=rows_s, build={"wall_s": build_s, "kmeans_s": build_times["kmeans_fit"][0],
                                           "shard_writes_s": build_times["append_cluster_s"],
                                           "host_other_s": build_s - build_times["kmeans_fit"][0]
                                           - build_times["append_cluster_s"],
                                           "disk_bytes": disk, "peak_device_bytes": build_peak},
                dedup={"wall_s": dedup_s, "removed": len(result["removed"]), "kept": len(result["kept"]),
                       "planted_copies": len(copies), "max_copy_cosine_distance": float(1.0 - cos.min()),
                       "cold_split": cold},
                query={"wall_s": query_s, "queries_per_s": INDEX_QUERIES / query_s, "split": warm,
                       "host_merge_s": warm["score_shards_s"] - warm["topk_s"],
                       "profiled": profiled, "peak_device_bytes": query_peak, "recall_at_8": rec},
            )
            # one server on the card: the request burst, then compaction under load
            t0 = time.monotonic()
            srv = IndexServer(str(root / "idx"), device=dev, cache_bytes=CACHE_BYTES, warmup_budget=CACHE_BYTES,
                              batch_window_s=0.002, max_batch=64, adopt_interval_s=0.25, gc_drained=True)
            boot_s = time.monotonic() - t0
            try:
                out["server"] = {"boot_s": boot_s, "warmed_bytes": srv.warmed_bytes,
                                 **drive_server(cs, timer, srv, index, ids, x, copies, fresh)}
                del index
                gc.collect()
                out["compaction"] = drive_compaction(cs, dev, srv, str(root / "idx"), ids, queries, corpus_dev)
            finally:
                srv.close()
            del corpus_dev
        return out
    finally:
        os.environ.pop("CURATE_INDEX_CACHE_BYTES", None)
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def drive_index_split(cs, dev, root: Path, corpus: list[Path]) -> dict:
    """Run E: build the index in a split run, then drop every clip of the
    same videos under new names against it, then ``run_dedup``'s fast
    path."""
    from cosmos_curate_tpu_torch.core.runner import default_runner
    from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex
    from cosmos_curate_tpu_torch.pipelines.video import split
    from cosmos_curate_tpu_torch.pipelines.video.dedup import DedupPipelineArgs, run_dedup
    from cosmos_curate_tpu_torch.pipelines.video.stages.dedup_stage import IncrementalDedupStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage

    n_clips = INDEX_SPLIT_VIDEOS * cs.SPLIT_CLIPS // cs.SPLIT_VIDEOS
    videos = cs.subset(root, corpus, "videos_e", INDEX_SPLIT_VIDEOS)
    again = root / "videos_e_again"  # the same content under new names: new clip uuids
    again.mkdir()
    for path in corpus[:INDEX_SPLIT_VIDEOS]:
        (again / f"again_{path.name}").symlink_to(path)
    stage_classes = (split.ClipEmbeddingStage, IncrementalDedupStage, ClipWriterStage)
    with allow_random("1"):
        first = cs.split_run(dev, replace(cs.split_args(videos, root / "out_e", corpus_index=True),
                                          embedding_model="clip", device=dev.type), default_runner(), stage_classes)
        block = first["summary"].get("corpus_index")
        assert block and block["consolidated"] == n_clips, f"run E: corpus_index block {block}"
        index = CorpusIndex.open(str(root / "out_e" / "index"), device=dev)
        second = cs.split_run(dev, replace(cs.split_args(again, root / "out_e2",
                                                         index_path=str(root / "out_e" / "index"),
                                                         incremental_dedup="enable"), embedding_model="clip",
                                                 device=dev.type),
                              default_runner(), stage_classes)
        s2 = second["summary"]
        assert s2["num_clips"] == s2["num_filtered_by_dedup"] == n_clips, f"run E: second run {s2}"
        metas = [json.loads(p.read_text()) for p in (root / "out_e2" / "metas" / "filtered").glob("*.json")]
        assert len(metas) == n_clips and all(m["filtered_by"] == "dedup" and m["duplicate_of"] for m in metas)
        # the uuid each duplicate points at: its own clip of the first run?
        first_metas = {p.stem: json.loads(p.read_text()) for p in (root / "out_e" / "metas" / "v0").glob("*.json")}
        span = {u: (Path(m["source_video"]).name, m["span_start"]) for u, m in first_metas.items()}
        own = sum(span.get(m["duplicate_of"]) == (Path(m["source_video"]).name.removeprefix("again_"),
                                                  m["span_start"]) for m in metas)
        t0 = time.monotonic()
        dedup = run_dedup(DedupPipelineArgs(input_path=str(root / "out_e"), output_path=str(root / "dedup_e"),
                                            device=dev.type))
        dedup_s = time.monotonic() - t0
        assert dedup["method"] == "index_query", dedup
        assert dedup["num_kept"] + dedup["num_removed"] == n_clips
    return dict(
        videos=INDEX_SPLIT_VIDEOS, clips=n_clips, allow_random="set by the phase",
        first={"wall_s": first["wall"], "corpus_index": block, "index_meta": index.meta,
               "stages": cs.stage_busy(first["spans"], first["wall"]), "launches": first["launches"]},
        second={"wall_s": second["wall"], "removed_by_dedup": s2["num_filtered_by_dedup"],
                "duplicate_of_own_first_run_clip": own, "stages": cs.stage_busy(second["spans"], second["wall"]),
                "launches": second["launches"]},
        run_dedup={"wall_s": dedup_s, "method": dedup["method"], "kept": dedup["num_kept"],
                   "removed": dedup["num_removed"]},
    )


def run(cs, dev, timer, root: Path, corpus: list[Path]) -> dict:
    """Both index phases in order, each line emitted as it ends; returns
    {phase: record}."""
    out = {"index": drive_index(cs, dev, timer)}
    cs.emit({"phase": "index", **out["index"]})
    out["index_split"] = drive_index_split(cs, dev, root, corpus)
    cs.emit({"phase": "index_split", **out["index_split"]})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("index_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    # pyarrow imported first in a worker thread has crashed a later read in
    # the main thread (pyarrow 25): import it here
    import pyarrow.parquet  # noqa: F401

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    timer, build_s = cs.phase_prologue(dev)
    with cs.split_corpus(INDEX_SPLIT_VIDEOS) as (root, corpus, corpus_s):
        cs.emit({"phase": "index_prologue", "build_s": build_s, "corpus_build_s": corpus_s})
        run(cs, dev, timer, root, corpus)
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
