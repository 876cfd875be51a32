"""Port parity: the single-host streaming engine (``engine/runner.py``,
``engine/pool.py``, ``engine/worker.py``), the shared-memory object store
(``engine/object_store.py``), ``LazyData`` (``data/lazy.py``) and
``MapRunner`` (``core/map_runner.py``).

The reference's cases (tests/engine/test_streaming_runner.py,
tests/core/test_map_runner.py, tests/engine/test_object_store.py) run
through both packages on the same toy stages (tests/fixtures/engine_stages_*.py:
module-level, so spawned workers import them), outputs compared. Worker
pools are real spawned processes: counts stay tiny, and the warm spares
are off (``CURATE_PREWARM=0``) but in the test that adopts them. Then
``run_split`` through the streaming engine: a fixed-stride split against
the port's pipelined run and the JAX package's streaming run (file names,
metas and summaries equal; clips are encoded in the workers, by the native
H.264 writer where it builds, whose bytes do not repeat), a profiled and
stage-saved split, and a traced one.
"""

from __future__ import annotations

import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest

from cosmos_curate_tpu.core.map_runner import MapRunner as JMapRunner
from cosmos_curate_tpu.core.pipeline import ExecutionMode as JExecutionMode
from cosmos_curate_tpu.core.pipeline import PipelineConfig as JPipelineConfig
from cosmos_curate_tpu.core.pipeline import StreamingSpec as JStreamingSpec
from cosmos_curate_tpu.core.pipeline import run_pipeline as jrun_pipeline
from cosmos_curate_tpu.core.stage import StageSpec as JStageSpec
from cosmos_curate_tpu.data import lazy as jlazy
from cosmos_curate_tpu.data.model import Clip as JClip
from cosmos_curate_tpu.data.model import SplitPipeTask as JSplitPipeTask
from cosmos_curate_tpu.data.model import Video as JVideo
from cosmos_curate_tpu.engine import object_store as jstore
from cosmos_curate_tpu.engine.runner import StreamingRunner as JStreamingRunner
from cosmos_curate_tpu.pipelines.video import split as jsplit
from cosmos_curate_tpu_torch import native
from cosmos_curate_tpu_torch.core.map_runner import MapRunner
from cosmos_curate_tpu_torch.core.pipeline import ExecutionMode, PipelineConfig, StreamingSpec, run_pipeline
from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
from cosmos_curate_tpu_torch.core.stage import StageSpec
from cosmos_curate_tpu_torch.data import lazy as tlazy
from cosmos_curate_tpu_torch.data.model import Clip, SplitPipeTask, Video
from cosmos_curate_tpu_torch.engine import object_store as store
from cosmos_curate_tpu_torch.engine.runner import StreamingRunner
from cosmos_curate_tpu_torch.pipelines.video import split as tsplit
from tests.fixtures import engine_stages_jax as js
from tests.fixtures import engine_stages_torch as ts
from tests.fixtures.media import make_scene_video
from tests.fixtures.observability import observability_state  # noqa: F401

SPLIT = dict(fixed_stride_len_s=1.0, min_clip_len_s=0.5)
CLOCK_KEYS = ("timestamp", "pipeline_run_time_s", "video_hours_per_day_per_chip")


@pytest.fixture(autouse=True)
def _engine_env(monkeypatch, tmp_path):
    monkeypatch.setenv("CURATE_PREWARM", "0")
    monkeypatch.setenv("CURATE_DLQ_DIR", str(tmp_path / "dlq"))
    monkeypatch.delenv("CURATE_RUNNER", raising=False)
    monkeypatch.delenv("CURATE_ENGINE_DRIVER_PORT", raising=False)


def _config(pkg: str, **kw):
    if pkg == "jax":
        mode = {"streaming": JExecutionMode.STREAMING, "batch": JExecutionMode.BATCH}[kw.pop("mode", "streaming")]
        return JPipelineConfig(execution_mode=mode, streaming=JStreamingSpec(autoscale_interval_s=3600.0,
                                                                             max_queued_lower_bound=4), **kw)
    mode = {"streaming": ExecutionMode.STREAMING, "batch": ExecutionMode.BATCH}[kw.pop("mode", "streaming")]
    return PipelineConfig(execution_mode=mode, streaming=StreamingSpec(autoscale_interval_s=3600.0),
                          max_queued_lower_bound=4, **kw)


# case -> (values in, [(stage factory name, args, spec kwargs)], config kwargs)
CASES = {
    "two_stage": (range(6), [("AddStage", (1,), {}), ("AddStage", (10,), {})], {}),
    "dynamic_chunking_and_drop": (range(3), [("FanOutStage", (), {}), ("DropOddStage", (), {})], {}),
    "failed_batch_dropped": ((1, 13, 5), [("FailOn13Stage", (), {"num_run_attempts": 2})], {}),
    "worker_crash_recovery": ((1, 7, 3), [("CrashStage", (), {"num_run_attempts": 2})], {}),
    "batch_mode": (range(4), [("AddStage", (1,), {}), ("FanOutStage", (), {})], {"mode": "batch"}),
    "empty_input": ((), [("AddStage", (), {})], {}),
}


def _run_case(pkg: str, case: str):
    values, stages, cfg = CASES[case]
    mod, spec, run, runner = (js, JStageSpec, jrun_pipeline, JStreamingRunner()) if pkg == "jax" else \
        (ts, StageSpec, run_pipeline, StreamingRunner())
    specs = [spec(getattr(mod, name)(*args), num_workers=1, **kw) for name, args, kw in stages]
    out = run([mod.Item(value=v) for v in values], specs, config=_config(pkg, **cfg), runner=runner)
    return sorted((t.value, tuple(t.trail)) for t in out), runner


@pytest.mark.parametrize("case", list(CASES))
def test_streaming_cases_match_jax(case):
    out, runner = _run_case("port", case)
    j_out, _ = _run_case("jax", case)
    assert out == j_out
    expected = {
        "two_stage": [11, 12, 13, 14, 15, 16], "dynamic_chunking_and_drop": [0, 10, 20],
        "failed_batch_dropped": [1, 5], "worker_crash_recovery": [1, 3], "empty_input": [],
    }
    if case in expected:
        assert [v for v, _ in out] == expected[case]
    if case == "batch_mode":
        assert len(out) == 8
    if case in ("failed_batch_dropped", "worker_crash_recovery"):
        # the dropped batch went to the dead-letter queue with its payload
        (name, counts), = runner.stage_counts.items()
        assert counts["errored"] == counts["dead_lettered"] == 1 and runner.dlq.recorded == 1
        entry = next(p for p in runner.dlq.run_dir.iterdir())
        meta = json.loads((entry / "meta.json").read_text())
        assert meta["stage"] == name and meta["num_tasks"] == 1
        assert ("worker_deaths" in meta) and (meta["worker_deaths"] == 4) == (case == "worker_crash_recovery")
    if case != "empty_input":
        assert runner.store_stats["objects"] > 0 and runner.store_stats["bytes_put"] > 0
        assert runner.worker_pids and os.getpid() not in runner.worker_pids


def test_setup_failure_raises_like_jax():
    for run, mod, spec, runner, pkg in ((run_pipeline, ts, StageSpec, StreamingRunner(), "port"),
                                        (jrun_pipeline, js, JStageSpec, JStreamingRunner(), "jax")):
        with pytest.raises(RuntimeError, match="setup failed"):
            run([mod.Item(value=1)], [spec(mod.BadSetupStage(), num_workers=1)], config=_config(pkg), runner=runner)


def test_cpu_workers_claim_no_card_and_device_stages_stay_in_the_driver(monkeypatch):
    """A CPU stage runs in a spawned worker with ``CUDA_VISIBLE_DEVICES=""``
    (the JAX package's workers pin ``JAX_PLATFORMS=cpu`` instead); a stage
    that claims the accelerator runs in the driver, in both packages. The
    warm spares are on here: the CPU stage's worker is one of them."""
    monkeypatch.setenv("CURATE_PREWARM", "1")
    runner = StreamingRunner()
    out = run_pipeline([ts.Item(value=i) for i in range(3)],
                       [StageSpec(ts.PidStage(), num_workers=1), StageSpec(ts.PidStage(device=True))],
                       config=_config("port", num_gpus=1), runner=runner)
    j_out = jrun_pipeline([js.Item(value=i) for i in range(3)],
                          [JStageSpec(js.PidStage(), num_workers=1), JStageSpec(js.PidStage(device=True))],
                          config=_config("jax", num_tpu_chips=1), runner=JStreamingRunner())
    for tasks, cpu_env, device_env in ((out, "", os.environ.get("CUDA_VISIBLE_DEVICES")),
                                       (j_out, os.environ.get("CUDA_VISIBLE_DEVICES"),
                                        os.environ.get("CUDA_VISIBLE_DEVICES"))):
        assert sorted(t.value for t in tasks) == [0, 1, 2]
        for t in tasks:
            cpu_pid, env, device_pid, denv = t.trail
            assert cpu_pid != os.getpid() and device_pid == os.getpid()
            assert (env, denv) == (cpu_env, device_env)
    assert {t.trail[0] for t in out} <= runner.worker_pids
    assert len(runner.worker_ready_s) >= 1 and all(s > 0 for s in runner.worker_ready_s)
    # the driver's puts (seeded inputs, the device stage's outputs) took the
    # native framing where it builds
    st = runner.store_stats
    assert st["driver_puts"] >= 6
    assert st["driver_native_puts"] == (st["driver_puts"] if native.load_native() is not None else 0)


def test_driver_port_refuses_the_remote_plane(monkeypatch):
    """``CURATE_ENGINE_DRIVER_PORT`` selects the cross-node plane, which
    refuses to run without its cluster secret (frames are authenticated
    before they are unpickled), as the reference's does; it never runs
    single-host instead."""
    monkeypatch.setenv("CURATE_ENGINE_DRIVER_PORT", "7070")
    monkeypatch.delenv("CURATE_ENGINE_TOKEN", raising=False)
    with pytest.raises(RuntimeError, match="CURATE_ENGINE_TOKEN"):
        run_pipeline([ts.Item(value=1)], [ts.AddStage()], runner=StreamingRunner())


# -- the object store ----------------------------------------------------------


def _task(pkg):
    clip, video, task = (Clip, Video, SplitPipeTask) if pkg == "port" else (JClip, JVideo, JSplitPipeTask)
    return task(video=video(path="v.mp4", raw_bytes=b"\x00" * 5000,
                            clips=[clip(source_video="v.mp4", span=(0.0, 5.0), encoded_data=b"z" * 100)]))


OBJECTS = {
    "simple": lambda pkg: {"a": 1, "b": "text"},
    "numpy": lambda pkg: {"x": np.arange(1000, dtype=np.float32).reshape(10, 100), "big": np.ones(1 << 18, np.uint8)},
    "task": _task,
    "bytes": lambda pkg: b"y" * 4000,
}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if hasattr(a, "video"):
        return (a.video.path, a.video.raw_bytes, a.video.clips[0].encoded_data) == \
            (b.video.path, b.video.raw_bytes, b.video.clips[0].encoded_data)
    return a == b


@pytest.mark.parametrize("obj", list(OBJECTS))
@pytest.mark.parametrize("framing", ["native", "python"])
def test_segments_read_across_packages(obj, framing, monkeypatch):
    """A segment the port writes (through either framing) reads back
    through the JAX ``get``, and one the JAX package writes through the
    port's: the layout is the reference's."""
    if framing == "python":
        monkeypatch.setattr(native, "load_native", lambda: None)
    elif native.load_native() is None:
        pytest.skip(f"the native framing does not build here: {native.native_error()}")
    before = store.stats()
    ref = store.put(OBJECTS[obj]("port"))
    j_ref = jstore.put(OBJECTS[obj]("jax"))
    try:
        after = store.stats()
        assert after["puts"] == before["puts"] + 1 and after["put_bytes"] == before["put_bytes"] + ref.total_size
        assert after["native_puts"] - before["native_puts"] == (framing == "native")
        assert _same(store.get(ref), OBJECTS[obj]("port")) and _same(jstore.get(ref), OBJECTS[obj]("port"))
        assert _same(store.get(j_ref), OBJECTS[obj]("jax"))
        raw = Path(store._SHM_DIR, ref.shm_name).read_bytes()
        assert len(raw) >= ref.total_size and _same(jstore.loads_segment(raw), OBJECTS[obj]("port"))
        if obj == "numpy":
            # the arrays travel out of band, as in the reference
            assert ref.num_buffers == j_ref.num_buffers >= 2 and ref.total_size > (1 << 18)
    finally:
        store.delete(ref)
        jstore.delete(j_ref)


def test_native_and_python_framing_write_the_same_bytes(monkeypatch):
    if native.load_native() is None:
        pytest.skip(f"the native framing does not build here: {native.native_error()}")
    obj = OBJECTS["numpy"]("port")
    a = store.put(obj)
    monkeypatch.setattr(native, "load_native", lambda: None)
    b = store.put(obj)
    try:
        assert Path(store._SHM_DIR, a.shm_name).read_bytes() == Path(store._SHM_DIR, b.shm_name).read_bytes()
    finally:
        store.delete(a)
        store.delete(b)


def test_delete_is_idempotent_like_jax():
    for mod in (store, jstore):
        ref = mod.put([1, 2, 3])
        mod.delete(ref)
        mod.delete(ref)
        with pytest.raises(FileNotFoundError):
            mod.get(ref)


def test_budget_accounting_matches_jax():
    for mod in (store, jstore):
        budget = mod.StoreBudget(capacity_bytes=7_000)
        r1, r2 = mod.put(b"x" * 4000), mod.put(b"y" * 4000)
        assert budget.has_headroom()
        budget.account(r1)
        assert budget.has_headroom()
        budget.account(r2)
        assert not budget.has_headroom()
        used = budget.used
        budget.release(r1)
        assert budget.used < used and budget.has_headroom()
        budget.release(r2)
        assert budget.used == 0
        tiny = mod.StoreBudget(capacity_bytes=10)
        assert tiny.has_headroom()  # an empty store admits one object
        big = mod.put(b"x" * 1000)
        tiny.account(big)
        assert tiny.used > 10 and not tiny.has_headroom()
        tiny.release(big)
        assert tiny.used == 0 and not Path(store._SHM_DIR, big.shm_name).exists()


def test_stale_segments_of_dead_owners_are_reclaimed(tmp_path):
    dead, alive = 2 ** 22 + 12345, os.getpid()
    for pid in (dead, alive):
        (tmp_path / f"cur{pid}-0123456789abcdef").write_bytes(b"x")
    (tmp_path / "other-file").write_bytes(b"x")
    assert store.cleanup_stale_segments(str(tmp_path)) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"cur{alive}-0123456789abcdef", "other-file"]
    (tmp_path / f"cur{dead}-0123456789abcdef").write_bytes(b"x")
    assert jstore.cleanup_stale_segments(str(tmp_path)) == 1


@pytest.mark.parametrize("state", ["inline", "stored", "cleared"])
def test_lazy_data_matches_jax(state, tmp_path):
    arr = np.arange(12, dtype=np.float32)
    results = []
    for mod in (tlazy, jlazy):
        d = mod.LazyData(arr.copy())
        if state == "stored":
            d.store(str(tmp_path / f"{mod.__name__}.pkl"))
        if state == "cleared":
            d.clear()
            results.append((d.is_inline, d.is_stored, d.nbytes(), repr(d)))
            with pytest.raises(RuntimeError, match="already cleared"):
                d.get()
            # a payload neither inline nor stored does not travel, in either package
            with pytest.raises(ValueError, match="needs an inline value"):
                pickle.loads(pickle.dumps(d))
            continue
        back = pickle.loads(pickle.dumps(d))
        results.append((d.is_inline, d.is_stored, d.nbytes(), repr(back).split(",")[0]))
        np.testing.assert_array_equal(back.get(), arr)
    assert results[0] == results[1]
    with pytest.raises(ValueError, match="needs an inline value"):
        tlazy.LazyData()


# -- MapRunner -----------------------------------------------------------------


MAP_CASES = {
    "end_to_end": (7, ["Add1", "Expand", "Add10"], {}),
    "fan_out": (6, ["Add1"], {}),
    "device_inline": (3, ["DeviceStage"], {}),
    "retries_then_drop": (4, ["AddFail2"], {"raise_on_error": False}),
    "empty": (0, ["Add1"], {}),
}


def _map_stage(mod, spec, name):
    return {
        "Add1": lambda: mod.Add(1), "Add10": lambda: mod.Add(10), "Expand": lambda: mod.Expand(),
        "DeviceStage": lambda: mod.DeviceStage(),
        "AddFail2": lambda: spec(mod.Add(1, fail_values=(2,)), num_run_attempts=2, num_workers=2),
    }[name]()


@pytest.mark.parametrize("case", list(MAP_CASES))
def test_map_runner_cases_match_jax(case):
    n, names, kw = MAP_CASES[case]
    results = {}
    for pkg, mod, spec, run, runner_cls in (("port", ts, StageSpec, run_pipeline, MapRunner),
                                            ("jax", js, JStageSpec, jrun_pipeline, JMapRunner)):
        runner = runner_cls(max_workers=2, **kw)
        out = run([mod.Num(i) for i in range(n)], [_map_stage(mod, spec, name) for name in names], runner=runner)
        results[pkg] = (sorted(t.v for t in out), {p for t in out for p in t.pids}, runner)
    (vals, pids, runner), (j_vals, j_pids, _) = results["port"], results["jax"]
    assert vals == j_vals
    if case == "end_to_end":
        assert len(vals) == 14 and vals == sorted(i + 11 for i in range(7) for _ in range(2))
    if case == "fan_out":
        assert os.getpid() not in pids and runner.stage_times["add1"] > 0
    if case == "device_inline":
        assert pids == j_pids == {os.getpid()}
    if case == "retries_then_drop":
        assert vals == [1, 2]  # the batch [2, 3] is dropped after its retries
    if case == "empty":
        assert vals == []


def test_map_runner_raises_on_error_like_jax():
    for run, mod, spec, runner in ((run_pipeline, ts, StageSpec, MapRunner(max_workers=2)),
                                   (jrun_pipeline, js, JStageSpec, JMapRunner(max_workers=2))):
        with pytest.raises(Exception):
            run([mod.Num(2)], [spec(mod.Add(1, fail_values=(2,)), num_workers=2)], runner=runner)


# -- run_split through the streaming engine ------------------------------------


@pytest.fixture(scope="module")
def split_videos(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("engine_videos")
    for i, scenes in enumerate((2, 1)):
        make_scene_video(d / f"video_{i}.mp4", scene_len_frames=24, num_scenes=scenes)
    return d


def _files(out: Path, skip=("profile/", "stage_save/", "report/")) -> set[str]:
    return {f for f in (str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()) if not f.startswith(skip)}


def _metas(out: Path) -> dict:
    return {p.stem: json.loads(p.read_text()) for p in (out / "metas" / "v0").glob("*.json")}


def _counts(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in CLOCK_KEYS}


def test_streaming_split_matches_the_pipelined_and_the_jax_engine(split_videos, tmp_path, monkeypatch):
    """``CURATE_RUNNER=streaming`` in both packages, beside the port's
    pipelined run on the same videos."""
    monkeypatch.setenv("CURATE_RUNNER", "streaming")
    summary = tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(split_videos),
                                                        output_path=str(tmp_path / "stream"), **SPLIT))
    j_summary = jsplit.run_split(jsplit.SplitPipelineArgs(input_path=str(split_videos),
                                                          output_path=str(tmp_path / "jstream"), **SPLIT))
    monkeypatch.delenv("CURATE_RUNNER")
    piped = tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(split_videos),
                                                      output_path=str(tmp_path / "piped"), **SPLIT),
                             runner=PipelinedRunner(raise_on_error=False))
    assert _counts(summary) == _counts(j_summary) == _counts(piped)
    assert summary["num_videos"] == 2 and summary["num_clips"] == summary["num_transcoded"] == 3
    assert _files(tmp_path / "stream") == _files(tmp_path / "jstream") == _files(tmp_path / "piped")
    assert _metas(tmp_path / "stream") == _metas(tmp_path / "jstream") == _metas(tmp_path / "piped")
    status = json.loads((tmp_path / "stream" / "report" / "live" / "status.json").read_text())
    assert status["state"] == "finished" and status["runner"] == "streaming"
    assert sorted(status["stages"]) == sorted(json.loads(
        (tmp_path / "jstream" / "report" / "live" / "status.json").read_text())["stages"])


def test_profiled_and_saved_split_under_the_streaming_engine(split_videos, tmp_path):
    """Profiling and stage-save wrappers travel to the spawned workers by
    value: each CPU stage's profile is written there, named with the
    worker's pid, and its inputs are saved; the outputs are the plain
    streaming run's."""
    runner = StreamingRunner()
    args = dict(input_path=str(split_videos), **SPLIT)
    tsplit.run_split(tsplit.SplitPipelineArgs(output_path=str(tmp_path / "prof"), profile_cpu=True,
                                              profile_memory=True, stage_save_rate=1.0, **args), runner=runner)
    plain_run = tsplit.run_split(tsplit.SplitPipelineArgs(output_path=str(tmp_path / "plain"), **args),
                                 runner=StreamingRunner())
    stages = {"VideoDownloadStage", "FixedStrideExtractorStage", "ClipTranscodingStage", "ClipFrameExtractionStage",
              "ClipWriterStage"}
    for kind in ("cpu", "memory"):
        arts = list((tmp_path / "prof" / "profile" / kind).glob("*.txt"))
        assert {p.stem.rsplit("-", 1)[0] for p in arts} == stages, kind
        pids = {int(p.stem.rsplit("-", 1)[1]) for p in arts}
        assert os.getpid() not in pids and pids <= runner.worker_pids
    saved = tmp_path / "prof" / "stage_save" / "stage_inputs"
    assert {p.name for p in saved.iterdir()} == stages and all(any(p.iterdir()) for p in saved.iterdir())
    assert _files(tmp_path / "prof") == _files(tmp_path / "plain")
    assert _metas(tmp_path / "prof") == _metas(tmp_path / "plain")
    assert plain_run["num_clips"] == 3


def test_traced_streaming_split_joins_the_workers_spans(split_videos, tmp_path):
    """Every worker's spans parent onto the driver's stage spans: one trace
    id over several processes, as in the JAX package's engine."""
    tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(split_videos), output_path=str(tmp_path / "out"),
                                              tracing=True, **SPLIT), runner=StreamingRunner())
    jsplit.run_split(jsplit.SplitPipelineArgs(input_path=str(split_videos), output_path=str(tmp_path / "jout"),
                                              tracing=True, **SPLIT), runner=JStreamingRunner())
    report = json.loads((tmp_path / "out" / "report" / "run_report.json").read_text())
    j_report = json.loads((tmp_path / "jout" / "report" / "run_report.json").read_text())
    for r in (report, j_report):
        assert r["connected"] and r["processes"] >= 2
    names = {n for n in report["spans_by_name"] if not n.startswith("storage.")}
    j_names = {n for n in j_report["spans_by_name"] if not n.startswith("storage.")}
    assert names == j_names
    assert report["stage_counts"].keys() == j_report["stage_counts"].keys()
