"""The port's live status and anomaly detector
(``cosmos_curate_tpu_torch/observability/live_status.py``, ``anomaly.py``)
against the JAX package's: the publisher's snapshot schema, the live-status
directory export, the snapshots both packages' ``SequentialRunner`` and
``PipelinedRunner`` publish over the same toy pipeline, the detector's
verdicts over one seeded sequence of snapshots, and a chaos
``worker.batch.hang`` that must show as a ``stuck_batch`` anomaly in the
live snapshot while the batch still hangs, in both packages.

Both packages' tracers, environment and aggregates are restored after every
test (tests/fixtures/observability.py)."""

from __future__ import annotations

import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from cosmos_curate_tpu import chaos as jchaos
from cosmos_curate_tpu.core import stage as jstage
from cosmos_curate_tpu.core import tasks as jtasks
from cosmos_curate_tpu.core.pipeline import PipelineConfig as JPipelineConfig
from cosmos_curate_tpu.core.pipeline import run_pipeline as jrun_pipeline
from cosmos_curate_tpu.core.pipelined_runner import PipelinedRunner as JPipelinedRunner
from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.observability import anomaly as janomaly
from cosmos_curate_tpu.observability import live_status as jlive
from cosmos_curate_tpu_torch import chaos as tchaos
from cosmos_curate_tpu_torch.core import stage as tstage
from cosmos_curate_tpu_torch.core import tasks as ttasks
from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig as TPipelineConfig
from cosmos_curate_tpu_torch.core.pipeline import run_pipeline as trun_pipeline
from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner as TPipelinedRunner
from cosmos_curate_tpu_torch.core.runner import SequentialRunner as TSequentialRunner
from cosmos_curate_tpu_torch.observability import anomaly as tanomaly
from cosmos_curate_tpu_torch.observability import live_status as tlive
from tests.fixtures.observability import observability_state  # noqa: F401  (autouse)

TIMEOUT_S = 60.0
HANG_S = 4.0


def toy_package(name: str) -> SimpleNamespace:
    """One package's runners and a toy two-stage pipeline: ``Bump`` adds 1
    in batches of 2, ``Double`` doubles in batches of 3 (and raises on a
    value in ``fail_on``)."""
    stage, tasks = (jstage, jtasks) if name == "jax" else (tstage, ttasks)

    class Num(tasks.PipelineTask):
        def __init__(self, v: int) -> None:
            self.v = v

    class Bump(stage.Stage):
        @property
        def resources(self):
            return stage.Resources(cpus=0.5)

        @property
        def batch_size(self) -> int:
            return 2

        def process_data(self, batch):
            return [Num(t.v + 1) for t in batch]

    class Double(stage.Stage):
        def __init__(self, fail_on=()) -> None:
            self.fail_on = set(fail_on)

        @property
        def resources(self):
            return stage.Resources(cpus=0.5)

        @property
        def batch_size(self) -> int:
            return 3

        def process_data(self, batch):
            if any(t.v in self.fail_on for t in batch):
                raise RuntimeError("poisoned batch")
            return [Num(2 * t.v) for t in batch]

    if name == "jax":
        pkg = SimpleNamespace(run_pipeline=jrun_pipeline, config=JPipelineConfig, sequential=JSequentialRunner,
                              pipelined=JPipelinedRunner, chaos=jchaos, live=jlive)
    else:
        pkg = SimpleNamespace(run_pipeline=trun_pipeline, config=TPipelineConfig, sequential=TSequentialRunner,
                              pipelined=TPipelinedRunner, chaos=tchaos, live=tlive)
    pkg.Num, pkg.Bump, pkg.Double, pkg.StageSpec = Num, Bump, Double, stage.StageSpec
    return pkg


def run_toy(pkg, runner_name: str, *, n: int = 8, fail_on=(), **runner_kw) -> list[int]:
    runner = pkg.sequential(**runner_kw) if runner_name == "sequential" else pkg.pipelined(**runner_kw)
    out = pkg.run_pipeline([pkg.Num(i) for i in range(n)], [pkg.Bump(), pkg.Double(fail_on)],
                           config=pkg.config(return_last_stage_outputs=True), runner=runner)
    return sorted(t.v for t in out or [])


def _keys(d: dict) -> set[str]:
    return set(d)


def test_publisher_snapshot_schema_matches_jax(tmp_path):
    snaps = {}
    for name, live in (("jax", jlive), ("torch", tlive)):
        pub = live.LiveStatusPublisher(str(tmp_path / name), runner="pipelined", interval_s=0.0)
        running = pub.publish({"stages": {"A": {"queue_depth": 1, "inflight": []}}})
        assert pub.maybe_publish(lambda: {"stages": {}}) is not None  # interval 0: always due
        pub.finalize({"stages": {"A": {"finished": True}}})
        final = live.read_status(str(tmp_path / name))
        snaps[name] = (running, final)
        assert final["state"] == "finished" and final["seq"] == 3 and running["state"] == "running"
        assert live.read_status(str(tmp_path / name / "status.json")) == final
    for got, want in zip(snaps["torch"], snaps["jax"], strict=True):
        assert _keys(got) == _keys(want)
        assert got["schema_version"] == want["schema_version"] and got["version"] == want["version"]
    assert tlive.read_status(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("root,enabled", [("local", "1"), ("s3://bucket/out", "1"), ("local", "0")])
def test_live_status_dir_export_matches_jax(root, enabled, tmp_path, monkeypatch):
    out = str(tmp_path / "out") if root == "local" else root
    monkeypatch.setenv("CURATE_LIVE_STATUS", enabled)
    monkeypatch.setenv(tlive.LIVE_STATUS_DIR_ENV, "/previous/run")
    got = tlive.export_live_status_dir(out)
    got_env = tlive.live_status_dir()
    monkeypatch.setenv(tlive.LIVE_STATUS_DIR_ENV, "/previous/run")
    want = jlive.export_live_status_dir(out)
    assert (got, got_env) == (want, jlive.live_status_dir())
    if root == "local" and enabled == "1":
        assert got == str(tmp_path / "out" / "report" / "live")
    else:
        assert got is None


@pytest.mark.parametrize("runner_name", ["sequential", "pipelined"])
def test_runner_snapshots_match_jax(runner_name, tmp_path, monkeypatch):
    # one running snapshot, then the final one: a sub-millisecond cadence
    # would hand the detector a throughput trend of noise
    monkeypatch.setenv("CURATE_LIVE_STATUS_INTERVAL_S", "60")
    snaps, outs = {}, {}
    for name in ("jax", "torch"):
        pkg = toy_package(name)
        root = tmp_path / name
        monkeypatch.setenv("CURATE_LIVE_STATUS_DIR", str(root / "report" / "live"))
        outs[name] = run_toy(pkg, runner_name)
        snaps[name] = pkg.live.read_status(str(root))
    assert outs["torch"] == outs["jax"] == [2 * (i + 1) for i in range(8)]
    got, want = snaps["torch"], snaps["jax"]
    assert _keys(got) == _keys(want)
    assert got["state"] == want["state"] == "finished" and got["runner"] == want["runner"] == runner_name
    assert list(got["stages"]) == list(want["stages"]) == ["Bump", "Double"]
    for stage, st in got["stages"].items():
        assert _keys(st) == _keys(want["stages"][stage]), stage
        assert st["inflight"] == []
        if runner_name == "pipelined":
            assert st["finished"] and st["completed"] == want["stages"][stage]["completed"]
    assert got["anomalies"] == want["anomalies"] == [] and got["anomaly_count"] == 0


def _snapshots(seed: int) -> list[dict]:
    """A seeded run of live snapshots: two stages, batches that age and
    clear, a stalling queue upstream and bursts of dispatch gap."""
    rng = np.random.default_rng(seed)
    snaps, completed, gap, compute, dispatches = [], 0, 0.0, 0.0, 0
    for tick in range(40):
        completed += int(rng.integers(0, 4)) if tick < 25 else 0
        dispatches += 10
        gap += float(rng.random() * (5.0 if 15 <= tick < 20 else 0.1))
        compute += float(rng.random())
        inflight = [{"batch_id": b, "age_s": float(rng.random() * 30), "worker": f"w{b}"}
                    for b in range(int(rng.integers(0, 3)))]
        stages = {
            "Up": {"workers": 1, "queue_depth": int(rng.integers(0, 20)), "busy_frac": float(rng.random()),
                   "dispatched": tick, "completed": completed, "inflight": [], "p99_s": 0.5},
            "Down": {"workers": 1, "queue_depth": 0 if tick % 3 else 2, "busy_frac": 0.0 if tick % 2 else 0.5,
                     "dispatched": tick, "completed": completed // 2, "inflight": inflight,
                     "p99_s": float(rng.random())},
        }
        snaps.append({"ts": 1000.0 + 2 * tick, "stages": stages,
                      "dispatch": {"embed/x": {"dispatches": dispatches, "gap_s": gap, "compute_s": compute}},
                      "nodes": {"n1": {"heartbeat_age_s": float(rng.random() * 20)}}})
    return snaps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_anomaly_verdicts_match_jax(seed):
    got, want = [], []
    t_det = tanomaly.AnomalyDetector(tanomaly.AnomalyConfig(stuck_min_age_s=5.0), emit=False)
    j_det = janomaly.AnomalyDetector(janomaly.AnomalyConfig(stuck_min_age_s=5.0), emit=False)
    for snap in _snapshots(seed):
        got.append([{k: v for k, v in ev.items() if k != "ts"} for ev in t_det.observe(json.loads(json.dumps(snap)))])
        want.append([{k: v for k, v in ev.items() if k != "ts"} for ev in j_det.observe(json.loads(json.dumps(snap)))])
    assert got == want
    kinds = {ev["kind"] for evs in got for ev in evs}
    assert {"stuck_batch", "heartbeat_degraded", "dispatch_gap_spike"} <= kinds
    assert t_det.emitted_total == j_det.emitted_total == sum(map(len, got))


def test_anomaly_config_reads_the_same_environment(monkeypatch):
    for name, value in (("CURATE_ANOMALY_STUCK_MIN_AGE_S", "1.5"), ("CURATE_ANOMALY_STUCK_FACTOR", "x"),
                        ("CURATE_ANOMALY_STARVED_QUEUE_DEPTH", "3"), ("CURATE_ANOMALY_GAP_FRAC", "0.5")):
        monkeypatch.setenv(name, value)
    assert vars(tanomaly.AnomalyConfig.from_env()) == vars(janomaly.AnomalyConfig.from_env())
    assert tanomaly.AnomalyConfig.from_env().stuck_min_age_s == 1.5


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_hung_batch_shows_as_stuck_while_it_hangs(name, tmp_path, monkeypatch):
    """A chaos hang in the first batch: the pipelined runner's live snapshot
    carries a ``stuck_batch`` anomaly for it while the run is still inside
    that batch."""
    pkg = toy_package(name)
    live_dir = tmp_path / "report" / "live"
    monkeypatch.setenv("CURATE_LIVE_STATUS_DIR", str(live_dir))
    monkeypatch.setenv("CURATE_LIVE_STATUS_INTERVAL_S", "0.05")
    monkeypatch.setenv("CURATE_ANOMALY_STUCK_MIN_AGE_S", "0.3")
    pkg.chaos.install(pkg.chaos.FaultPlan(rules=(
        pkg.chaos.FaultRule(site=pkg.chaos.SITE_WORKER_HANG, kind="hang", delay_s=HANG_S, count=1),)))
    result: dict = {}

    def run() -> None:
        try:
            result["out"] = run_toy(pkg, "pipelined", n=4)
        except BaseException as e:  # surfaced by the assertions below
            result["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    started = time.monotonic()
    thread.start()
    seen = None
    done = threading.Event()
    try:
        while time.monotonic() - started < HANG_S and seen is None:
            snap = pkg.live.read_status(str(live_dir)) or {}
            stuck = [a for a in snap.get("anomalies") or () if a["kind"] == "stuck_batch"]
            if stuck:
                seen = (time.monotonic() - started, stuck[0], snap)
            done.wait(0.02)
        still_hanging = thread.is_alive()
    finally:
        thread.join(TIMEOUT_S)
        pkg.chaos.uninstall()
    assert not thread.is_alive(), "the toy pipeline did not finish"
    assert "error" not in result, result.get("error")
    assert result["out"] == [2 * (i + 1) for i in range(4)]
    assert seen is not None, f"no stuck_batch anomaly within the {HANG_S} s hang"
    elapsed, event, snap = seen
    assert still_hanging and elapsed < HANG_S
    assert event["stage"] == "Bump" and event["batch_id"] == 0 and event["age_s"] > event["threshold_s"] >= 0.3
    assert [b["batch_id"] for b in snap["stages"]["Bump"]["inflight"]] == [0]
    final = pkg.live.read_status(str(live_dir))
    assert final["state"] == "finished" and final["anomaly_count"] >= 1
