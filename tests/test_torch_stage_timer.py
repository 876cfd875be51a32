"""The port's stage_timer (``cosmos_curate_tpu_torch/observability/
stage_timer.py``) against the JAX package's: one seeded sequence of every
``record_*`` call goes into both, and every ``*_summaries`` comes out equal;
the dispatch dump and its merges; and the device pipeline's records folded
into the dispatch aggregate, with its ``device.<name>.drain`` span, against
the JAX package's device pipeline on the same batches.

Both packages' tracers, environment and aggregates are restored after every
test (tests/fixtures/observability.py)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosmos_curate_tpu.models import device_pipeline as jdp
from cosmos_curate_tpu.observability import stage_timer as jst
from cosmos_curate_tpu.observability import tracing as jtracing
from cosmos_curate_tpu_torch.models import device_pipeline as tdp
from cosmos_curate_tpu_torch.observability import stage_timer as tst
from cosmos_curate_tpu_torch.observability import tracing as ttracing
from tests.fixtures.observability import observability_state  # noqa: F401  (autouse)

SEED = 16
STAGES = ("ClipEmbeddingStage", "CaptionStage", "writer")


def _record_everything(st, seed: int = SEED) -> None:
    """The same seeded calls of every recorder into one package."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        name = f"embed/{STAGES[int(rng.integers(3))]}"
        padded = int(2 ** rng.integers(0, 6))
        st.record_dispatch(name, st.DispatchRecord(
            h2d_s=float(rng.random() * 1e-3), compute_s=float(rng.random() * 1e-2), d2h_s=float(rng.random() * 1e-3),
            gap_s=float(rng.random() * 1e-3), rows=int(rng.integers(1, padded + 1)), padded_rows=padded))
    for _ in range(30):
        stage = STAGES[int(rng.integers(3))]
        st.record_stage_busy(stage, float(rng.random()))
        st.record_stage_flow(stage, queue_depth=int(rng.integers(0, 9)), busy_frac=float(rng.random()),
                             workers=int(rng.integers(1, 4)))
    for i in range(12):
        phases = {k: float(rng.random()) for k in ("prep_s", "vision_encode_s", "prefill_s", "decode_s", "idle_s",
                                                   "wall_s")}
        phases.update({k: int(rng.integers(0, 50)) for k in ("requests", "prefill_tokens", "prefix_cache_hits",
                                                              "prefix_cache_misses", "decode_tokens",
                                                              "prefix_block_refs", "paged_kernel_steps")})
        phases.update(kv_blocks_total=64, kv_blocks_used=int(rng.integers(0, 64)),
                      kv_blocks_peak=int(rng.integers(0, 64)), owner=f"caption-default-{i % 2}")
        st.record_caption_phases("CaptionStage" if i % 3 else "EnhanceCaptionStage", phases)
    for i in range(10):
        st.record_index_ops(("corpus_index", "consolidate")[i % 2], adds=int(rng.integers(0, 100)),
                            add_s=float(rng.random()), queries=int(rng.integers(0, 40)),
                            probes=int(rng.integers(0, 200)), query_s=float(rng.random()),
                            duplicates=int(rng.integers(0, 5)), skipped_random=int(rng.integers(0, 3)),
                            not_a_key=7)
    for i in range(25):
        st.record_search("index_server", latency_s=float(rng.random() * 0.05), mode=("clip", "text")[i % 2],
                         searches=1, queries=int(rng.integers(1, 9)), cache_hit_bytes=int(rng.integers(0, 1 << 20)),
                         cache_miss_bytes=int(rng.integers(0, 1 << 18)))
    st.record_search("index_server", batches=3, batched_requests=25, search_s=0.125)
    st.record_search("compaction", compactions=1, compaction_s=0.5, generation=4)
    st.record_search("compaction", compactions=1, compaction_s=0.25, generation=2)
    for i in range(5):
        st.record_anomaly({"kind": ("stuck_batch", "starved_stage")[i % 2], "stage": STAGES[i % 3],
                           "batch_id": i, "detail": f"d{i}", "ts": 1700000000.0 + i})
    st.record_anomaly({"detail": "no kind, no stage"})
    st.record_object_plane(store_reads=3, store_read_bytes=12345, store_read_wait_s=0.5, bogus=1)
    st.record_object_plane(store_reads=1, store_read_bytes=10, store_read_wait_s=0.125)
    st.record_node_object_plane("node-b", {"fetches": 2, "fetch_bytes": 99, "fetch_wait_s": 0.75})


SUMMARIES = ("dispatch_summaries", "stage_flow_summaries", "caption_phase_summaries", "index_op_summaries",
             "search_summaries", "anomaly_summaries", "object_plane_summaries")


@pytest.mark.parametrize("summary", SUMMARIES)
@pytest.mark.parametrize("node", [None, "node-7"])
def test_every_summary_equals_jax(summary, node, monkeypatch):
    if node is None:
        monkeypatch.delenv(tst.NODE_ID_ENV, raising=False)
    else:
        monkeypatch.setenv(tst.NODE_ID_ENV, node)
    _record_everything(tst)
    _record_everything(jst)
    got, want = getattr(tst, summary)(), getattr(jst, summary)()
    assert got == want
    assert got  # every section holds something


def test_resets_empty_every_section():
    _record_everything(tst)
    for reset in ("reset_dispatch_stats", "reset_stage_flow", "reset_caption_phases", "reset_index_ops",
                  "reset_search", "reset_anomalies", "reset_object_plane"):
        getattr(tst, reset)()
    assert all(getattr(tst, s)() == {} for s in SUMMARIES)


def test_dispatch_dump_and_merges_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(tst.NODE_ID_ENV, "node-a")
    for st, name in ((tst, "torch"), (jst, "jax")):
        _record_everything(st)
        st._dump_summaries(str(tmp_path / name / "own"))
    (t_dump,), (j_dump,) = ((tmp_path / n / "own").glob("dispatch-*.json") for n in ("torch", "jax"))
    assert json.loads(t_dump.read_text()) == json.loads(j_dump.read_text())
    # another process's dump (another pid), folded once
    other = {"embed/x": {"dispatches": 4, "rows": 10, "padded_rows": 16, "h2d_s": 0.5, "compute_s": 2.0,
                         "d2h_s": 0.25, "gap_s": 0.125, "node": "node-b"},
             tst.OBJECT_PLANE_DUMP_KEY: {"store_reads": 2, "store_read_bytes": 77, "node": "node-b"}}
    merged = {}
    for st, name in ((tst, "torch"), (jst, "jax")):
        d = tmp_path / name / "others"
        d.mkdir()
        (d / "dispatch-1.json").write_text(json.dumps(other))
        (d / "dispatch-2.json").write_text("{not json")  # a torn dump is skipped
        first = st.merge_new_dumped_summaries(str(d))
        again = st.merge_new_dumped_summaries(str(d))
        merged[name] = (first, again, st.load_dumped_summaries(str(d)), st.dispatch_summaries(),
                        st.object_plane_summaries())
    assert merged["torch"] == merged["jax"]
    first, again, loaded, summaries, plane = merged["torch"]
    assert first["embed/x"]["dispatches"] == 4 and again == {}
    assert loaded["embed/x"]["gap_frac"] == round(0.125 / 2.125, 4)
    assert summaries["embed/x"]["node"] == "node-b" and plane["node-b"]["store_reads"] == 2


@pytest.mark.parametrize("n,cap", [(11, 4), (3, 32), (40, 8), (1, 1)])
def test_device_pipeline_records_fold_like_jax(n, cap, tmp_path):
    x = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    ttracing.enable_tracing(str(tmp_path / "t" / "t.ndjson"))
    jtracing.enable_tracing(str(tmp_path / "j" / "t.ndjson"))
    tpipe = tdp.DevicePipeline("embed/test", lambda a: a * 2, device="cpu", micro_batch=cap)
    jpipe = jdp.DevicePipeline("embed/test", lambda p, a: jnp.asarray(a) * 2, micro_batch=cap)
    np.testing.assert_array_equal(tpipe.run(x), 2 * x)
    np.testing.assert_array_equal(jpipe.run(None, x), 2 * x)
    assert tpipe.drain() == [] and jpipe.drain() == []  # an empty drain opens no span
    ttracing.disable_tracing()
    jtracing.disable_tracing()
    got, want = tst.dispatch_summaries()["embed/test"], jst.dispatch_summaries()["embed/test"]
    for key in ("dispatches", "rows", "padded_rows", "node"):
        assert got[key] == want[key], key
    records = list(tpipe.records)
    assert got["dispatches"] == len(records) and got["rows"] == n == sum(r.rows for r in records)
    for key in ("h2d_s", "compute_s", "d2h_s", "gap_s"):
        assert got[key] == round(sum(getattr(r, key) for r in records), 4), key
    spans = {name: [json.loads(line) for line in (tmp_path / name / "t.ndjson").read_text().splitlines()]
             for name in ("t", "j")}
    assert [(s["name"], s["attributes"]) for s in spans["t"]] == [(s["name"], s["attributes"]) for s in spans["j"]]
    assert spans["t"] == [] or spans["t"][0]["name"] == "device.embed/test.drain"


def test_device_pipeline_record_is_stage_timers():
    assert tdp.DispatchRecord is tst.DispatchRecord
    pipe = tdp.DevicePipeline("embed/x", lambda a: torch.as_tensor(a) + 1, device="cpu", micro_batch=2)
    pipe.run(np.zeros((3, 2), np.float32))
    assert all(isinstance(r, tst.DispatchRecord) for r in pipe.records)
    assert tst.dispatch_summaries()["embed/x"]["dispatches"] == 2
