"""Port parity: node loss in the cross-node plane. The lineage tracker
(``engine/lineage.py``), the failure detector (``engine/remote_plane.py``),
the runner's lineage reconstruction (``engine/runner.py``), the chaos hand-off
(``chaos/harness.py``) and the DLQ's node-loss fields, and end to end: a
loopback agent killed by chaos ``agent.kill`` mid-run.

The tracker and reconstruction scenarios are the reference's
(tests/engine/test_node_loss.py): each runs through both packages on the
same refs and fabricated owners, and every observation (physical deletes in
order, holds, chains, re-run queues, waiters, ledger entries, counts) must
be equal. The end-to-end test starts two ``python -m
cosmos_curate_tpu_torch.engine.remote_agent`` processes on 127.0.0.1 (the
driver's port from a socket bound to port 0), pins ``agent.kill`` to one of
them, and holds the run to the same run without the fault.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import pytest

from cosmos_curate_tpu import chaos as jchaos
from cosmos_curate_tpu.cli import dlq_cli as jdlq_cli
from cosmos_curate_tpu.engine import dead_letter as jdead_letter
from cosmos_curate_tpu.engine import lineage as jlineage
from cosmos_curate_tpu.engine import object_store as jstore
from cosmos_curate_tpu.engine import remote_plane as jplane
from cosmos_curate_tpu.engine import runner as jrunner
from cosmos_curate_tpu.engine import worker as jworker
from cosmos_curate_tpu_torch import chaos as tchaos
from cosmos_curate_tpu_torch.cli import dlq_cli as tdlq_cli
from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig, PipelineSpec
from cosmos_curate_tpu_torch.core.stage import StageSpec
from cosmos_curate_tpu_torch.engine import dead_letter as tdead_letter
from cosmos_curate_tpu_torch.engine import lineage as tlineage
from cosmos_curate_tpu_torch.engine import object_store as tstore
from cosmos_curate_tpu_torch.engine import remote_plane as tplane
from cosmos_curate_tpu_torch.engine import runner as trunner
from cosmos_curate_tpu_torch.engine import worker as tworker
from tests.fixtures import engine_stages_torch as ts
from tests.fixtures.ports import free_port

REPO = Path(__file__).resolve().parents[1]
JAX = SimpleNamespace(lineage=jlineage, store=jstore, runner=jrunner, worker=jworker, dlq=jdead_letter,
                      plane=jplane)
TORCH = SimpleNamespace(lineage=tlineage, store=tstore, runner=trunner, worker=tworker, dlq=tdead_letter,
                        plane=tplane)



def _both(scenario, *args) -> dict:
    """The scenario's observations in both packages, asserted equal."""
    want, got = scenario(JAX, *args), scenario(TORCH, *args)
    assert got == want
    return got


# -- the lineage tracker ---------------------------------------------------------


def _ref(P, name: str, size: int = 64):
    return P.store.ObjectRef(name, size, 0)


def lineage_deferred_delete(P) -> dict:
    deleted: list[str] = []
    t = P.lineage.LineageTracker(lambda r: deleted.append(r.shm_name))
    seed, out = _ref(P, "cur1-seed"), _ref(P, "cur1-out")
    t.record(0, [seed], [out])
    t(seed)
    obs = {"after_seed": list(deleted), "held": t.is_held("cur1-seed")}
    t(out)
    obs.update(after_out=sorted(deleted), producer=t.producer("cur1-out"), held_after=t.is_held("cur1-seed"))
    return obs


def lineage_multiple_outputs(P) -> dict:
    deleted: list[str] = []
    t = P.lineage.LineageTracker(lambda r: deleted.append(r.shm_name))
    seed, o1, o2 = _ref(P, "cur1-s"), _ref(P, "cur1-o1"), _ref(P, "cur1-o2")
    t.record(0, [seed], [o1, o2])
    t(seed)
    t(o1)
    obs = {"after_o1": list(deleted), "records": t.num_records}
    t(o2)
    obs.update(after_o2=list(deleted), records_after=t.num_records)
    return obs


def lineage_chain(P) -> dict:
    t = P.lineage.LineageTracker(lambda r: None)
    seed, mid, out = _ref(P, "cur1-seed"), _ref(P, "cur1-mid"), _ref(P, "cur1-out")
    t.record(0, [seed], [mid])
    t.record(1, [mid], [out])
    return {"named": t.chain("cur1-out", ["StageA", "StageB"]), "unnamed": t.chain("cur1-out"),
            "lost": t.chain("cur1-nothing")}


def lineage_drain(P) -> dict:
    deleted: list[str] = []
    t = P.lineage.LineageTracker(lambda r: deleted.append(r.shm_name))
    seed, out = _ref(P, "cur1-seed"), _ref(P, "cur1-out")
    t.record(0, [seed], [out])
    t(seed)
    return {"drained": t.drain(), "deleted": deleted, "records": t.num_records}


def lineage_deep_hold(P) -> dict:
    """A released output still held as a downstream record's input keeps
    its own producer re-runnable (depth > 1)."""
    deleted: list[str] = []
    t = P.lineage.LineageTracker(lambda r: deleted.append(r.shm_name))
    seed, mid, out = _ref(P, "cur1-seed"), _ref(P, "cur1-mid"), _ref(P, "cur1-out")
    t.record(0, [seed], [mid])
    t(seed)
    t.record(1, [mid], [out])
    t(mid)
    obs = {"deleted": list(deleted), "mid_producer": t.producer("cur1-mid") is not None,
           "held": [t.is_held(n) for n in ("cur1-seed", "cur1-mid")]}
    t(out)
    obs.update(final=sorted(deleted), records=t.num_records)
    return obs


@pytest.mark.parametrize("scenario", [lineage_deferred_delete, lineage_multiple_outputs, lineage_chain, lineage_drain,
                                      lineage_deep_hold], ids=lambda f: f.__name__)
def test_lineage_tracker_matches_jax(scenario):
    _both(scenario)


# -- reconstruction in the runner --------------------------------------------------


class _FakeSpec:
    def __init__(self, name: str) -> None:
        self.name = name
        self.num_run_attempts = 1
        self.batch_timeout_s = None


class _FakeState:
    def __init__(self, name: str) -> None:
        self.spec = _FakeSpec(name)
        self.retry_queue = deque()
        self.errored_batches = 0
        self.dead_lettered = 0


class _FakeMgr:
    """Ownership is a name -> node map, death a set of node ids."""

    def __init__(self) -> None:
        self.locations: dict[str, str] = {}
        self.dead: set[str] = set()
        self.released: list[str] = []

    def owner_dead(self, ref) -> bool:
        node = self.locations.get(ref.shm_name)
        return node is not None and node in self.dead

    def node_of(self, name: str) -> str:
        return self.locations.get(name, "")

    def owner_node(self, ref) -> str:
        return self.locations.get(ref.shm_name, "")

    def release_data(self, ref) -> None:
        self.released.append(ref.shm_name)

    def fetch_value_if_remote(self, ref):
        return f"task:{ref.shm_name}"


def _recon_runner(P):
    runner = P.runner.StreamingRunner()
    mgr = _FakeMgr()
    runner._remote_mgr = mgr
    runner._tracker = P.lineage.LineageTracker(mgr.release_data)
    runner._recon_depth = 4
    runner._recon_budget = 16
    runner._stage_names = ["StageA", "StageB", "StageC"]
    states = [_FakeState(n) for n in runner._stage_names]
    store = P.store.StoreBudget(capacity_bytes=1 << 20, deleter=runner._tracker)
    return runner, mgr, states, store


def _queues(states) -> list:
    return [[[r.shm_name for r in b.refs] for b in st.retry_queue] for st in states]


def recon_depth_two(P) -> dict:
    runner, mgr, states, store = _recon_runner(P)
    seed, a_out, b_out = _ref(P, "cur1-seed"), _ref(P, "cur1-aout"), _ref(P, "cur1-bout")
    mgr.locations.update({"cur1-aout": "nodeB", "cur1-bout": "nodeB"})
    runner._tracker.record(0, [seed], [a_out])
    store.account(a_out)
    runner._tracker.record(1, [a_out], [b_out])
    store.release(a_out)
    store.account(b_out)
    mgr.dead.add("nodeB")
    waiter = P.runner._Batch(7, 2, [b_out])
    runner._on_lost_or_failed_inputs(states, states[2], waiter, store, "fetch failed: owner dead")
    obs = {"queues": _queues(states), "waiters": len(runner._lost_waiters)}
    rb0 = states[0].retry_queue.popleft()
    obs["rb0_id"] = rb0.batch_id
    new_a, new_b = _ref(P, "cur1-newa"), _ref(P, "cur1-newb")
    runner._handle_recon_result(states, rb0, P.worker.ResultMsg(rb0.batch_id, out_refs=[new_a]), store)
    obs["queues_after_a"] = _queues(states)
    rb1 = states[1].retry_queue.popleft()
    runner._handle_recon_result(states, rb1, P.worker.ResultMsg(rb1.batch_id, out_refs=[new_b]), store)
    back = states[2].retry_queue.popleft()
    rec = runner._tracker.producer("cur1-newb")
    obs.update(back_is_waiter=back is waiter, back_refs=[r.shm_name for r in back.refs],
               waiters_after=len(runner._lost_waiters), reconstructed=runner.objects_reconstructed,
               new_producer_inputs=[r.shm_name for r in rec.input_refs], tracks=[store.tracks(new_a),
                                                                                store.tracks(new_b)],
               released=mgr.released, spent=runner._recon_spent)
    return obs


def recon_rolls_back(P) -> dict:
    runner, mgr, states, store = _recon_runner(P)
    a_out, b_out = _ref(P, "cur1-aout"), _ref(P, "cur1-bout")
    mgr.locations.update({"cur1-aout": "nodeB", "cur1-bout": "nodeB"})
    runner._tracker.record(1, [a_out], [b_out])
    store.account(b_out)
    mgr.dead.add("nodeB")
    ok = runner._schedule_reconstruction(states, P.runner._Batch(11, 2, [b_out]), {"cur1-bout"}, store)
    rec = runner._tracker.producer("cur1-bout")
    return {"scheduled": ok, "recon": len(runner._recon), "waiters": len(runner._lost_waiters),
            "spent": runner._recon_spent, "inflight": rec.inflight_batch, "queues": _queues(states)}


def recon_unclaimed_parks(P) -> dict:
    runner, mgr, states, store = _recon_runner(P)
    seed, o1, o2 = _ref(P, "cur1-seed"), _ref(P, "cur1-o1"), _ref(P, "cur1-o2")
    mgr.locations.update({"cur1-o1": "nodeB", "cur1-o2": "nodeB"})
    runner._tracker.record(0, [seed], [o1, o2])
    store.account(o1)
    store.account(o2)
    mgr.dead.add("nodeB")
    w1 = P.runner._Batch(3, 1, [o1])
    runner._on_lost_or_failed_inputs(states, states[1], w1, store, "lost")
    rb = states[0].retry_queue.popleft()
    n1, n2 = _ref(P, "cur1-n1"), _ref(P, "cur1-n2")
    runner._handle_recon_result(states, rb, P.worker.ResultMsg(rb.batch_id, out_refs=[n1, n2]), store)
    obs = {"renamed": sorted(runner._renamed), "queues": _queues(states)}
    w2 = P.runner._Batch(4, 1, [o2])
    obs.update(adopted=runner._adopt_renamed(w2, store), w2=[r.shm_name for r in w2.refs],
               renamed_after=sorted(runner._renamed), reconstructed=runner.objects_reconstructed)
    return obs


def recon_budget_dead_letters(P, dlq_dir: str) -> dict:
    runner, mgr, states, store = _recon_runner(P)
    runner._recon_budget = 0
    runner.dlq = P.dlq.DeadLetterQueue(dlq_dir)
    seed, out = _ref(P, "cur1-seed"), _ref(P, "cur1-lost")
    mgr.locations["cur1-lost"] = "nodeB"
    runner._tracker.record(0, [seed], [out])
    store.account(out)
    mgr.dead.add("nodeB")
    batch = P.runner._Batch(9, 1, [out])
    requeued = 0
    for _ in range(P.runner.MAX_NODE_DEATHS_PER_BATCH + 1):
        runner._on_lost_or_failed_inputs(states, states[1], batch, store, "owner dead")
        if states[1].retry_queue:
            assert states[1].retry_queue.popleft() is batch
            requeued += 1
    (entry,) = P.dlq.list_entries(dlq_dir)
    meta = {k: entry.meta[k] for k in ("stage", "batch_id", "num_tasks", "attempts", "worker_deaths", "reason",
                                       "lost_node", "node_deaths", "lineage", "schema_version")}
    return {"requeued": requeued, "node_deaths": batch.node_deaths, "errored": states[1].errored_batches,
            "dead_lettered": states[1].dead_lettered, "meta": meta, "released": mgr.released}


@pytest.mark.parametrize("scenario", [recon_depth_two, recon_rolls_back, recon_unclaimed_parks],
                         ids=lambda f: f.__name__)
def test_reconstruction_matches_jax(scenario):
    obs = _both(scenario)
    if scenario is recon_depth_two:
        assert obs["back_is_waiter"] and obs["reconstructed"] == 2 and obs["rb0_id"] < 0


def test_budget_exhaustion_dead_letters_like_jax(tmp_path):
    obs = [recon_budget_dead_letters(P, str(tmp_path / name)) for P, name in ((JAX, "jax"), (TORCH, "torch"))]
    assert obs[1] == obs[0]
    assert obs[1]["meta"]["lost_node"] == "nodeB" and obs[1]["meta"]["lineage"][0]["produced_by_stage"] == "StageA"


# -- the failure detector ------------------------------------------------------------


def detector(P, hb: str, misses: str, silent_s: float, monkeypatch) -> dict:
    monkeypatch.setenv("CURATE_ENGINE_TOKEN", "t")
    monkeypatch.setenv("CURATE_AGENT_HEARTBEAT_S", hb)
    monkeypatch.setenv("CURATE_AGENT_HEARTBEAT_MISSES", misses)
    mgr = P.plane.RemoteWorkerManager(free_port(), __import__("queue").Queue(), local_cpu_budget=1.0)
    try:
        link = P.plane.AgentLink("n1", 4.0, sock=None, token=b"t")
        link.worker_costs["w1"] = 1.0
        mgr.agents.append(link)
        mgr._locations["cur1-abc"] = link
        proc = P.plane._RemoteProc(link, "w1")
        first = mgr.poll_node_deaths()
        link.last_seen = time.monotonic() - silent_s
        events = [{k: e[k] for k in ("node", "reason", "workers_lost")} for e in mgr.poll_node_deaths()]
        return {"first": first, "events": [{**e, "reason": e["reason"].split(" (")[0]} for e in events],
                "again": mgr.poll_node_deaths(), "alive": link.alive, "proc_alive": proc.is_alive(),
                "budgets": mgr.node_budgets(), "owner_dead": mgr.owner_dead(_ref(P, "cur1-abc")),
                "node_of": [mgr.node_of("cur1-abc"), mgr.node_of("cur1-x")]}
    finally:
        mgr.shutdown(drain_s=0)


@pytest.mark.parametrize("hb,misses,silent_s", [("0.2", "2", 5.0), ("0.2", "2", 0.0), ("0", "2", 50.0)],
                         ids=["deadline", "fresh", "deadline-off"])
def test_failure_detector_matches_jax(hb, misses, silent_s, monkeypatch):
    _both(detector, hb, misses, silent_s, monkeypatch)


# -- the chaos hand-off and the DLQ's node-loss fields ------------------------------------


def test_chaos_plan_hands_off_like_jax(monkeypatch):
    rules = [dict(site="agent.kill", kind="crash", count=1, worker_re="^agent-1$"),
             dict(site="object_channel.fetch", kind="error", probability=0.5)]
    jplan = jchaos.FaultPlan(seed=3, rules=tuple(jchaos.FaultRule(**r) for r in rules))
    tplan = tchaos.FaultPlan(seed=3, rules=tuple(tchaos.FaultRule(**r) for r in rules))
    assert tplan.to_json() == jplan.to_json()
    assert tchaos.FaultPlan.from_json(jplan.to_json()) == tplan
    assert set(jchaos.ALL_SITES) == set(tchaos.ALL_SITES)
    try:
        tchaos.install(tplan, export_env=True)
        assert os.environ[tchaos.CHAOS_ENV] == tplan.to_json()
        # worker_re: the kill arms only where CURATE_WORKER_ID matches
        monkeypatch.setenv("CURATE_WORKER_ID", "agent-0")
        tchaos.fire(tchaos.SITE_AGENT_KILL)  # a crash rule: it would exit here
        assert tchaos.fire_count(tchaos.SITE_AGENT_KILL) == 0
        fired = 0
        for _ in range(16):
            try:
                tchaos.fire(tchaos.SITE_OBJECT_CHANNEL_FETCH)
            except tchaos.InjectedFault:
                fired += 1
        jchaos.install(jplan)
        jfired = 0
        for _ in range(16):
            try:
                jchaos.fire(jchaos.SITE_OBJECT_CHANNEL_FETCH)
            except jchaos.InjectedFault:
                jfired += 1
        assert fired == jfired == tchaos.fire_count(tchaos.SITE_OBJECT_CHANNEL_FETCH) and 0 < fired < 16
    finally:
        tchaos.uninstall()
        jchaos.uninstall()
    assert tchaos.CHAOS_ENV not in os.environ
    monkeypatch.setenv(tchaos.CHAOS_ENV, tplan.to_json())
    try:
        assert tchaos.install_from_env() and tchaos.enabled()
    finally:
        tchaos.uninstall()


def test_dlq_lost_node_renders_like_jax(tmp_path, capsys):
    outs = []
    for name, dl, cli in (("jax", jdead_letter, jdlq_cli), ("torch", tdead_letter, tdlq_cli)):
        root = str(tmp_path / name)
        entry = dl.DeadLetterQueue(root, run_id="run-1").record(
            stage_name="StageB", batch_id=5, tasks=["t"], attempts=0, worker_deaths=0, reason="node died past budget",
            lost_node="node-b", node_deaths=4,
            lineage=[{"ref": "cur1-x", "produced_by_stage": "StageA", "inputs": ["cur1-s"]}])
        assert entry is not None
        cli._cmd_list(argparse.Namespace(dlq_dir=root, run_id=None, as_json=False))
        listed = capsys.readouterr().out
        cli._cmd_show(argparse.Namespace(entry=entry.name, dlq_dir=root))
        shown = capsys.readouterr().out
        outs.append((listed, "\n".join(ln for ln in shown.splitlines() if '"dropped_at"' not in ln
                                       and '"trace_id"' not in ln)))
    assert outs[1] == outs[0]
    assert "lost_node=node-b" in outs[1][0] and "lineage chain" in outs[1][1] and "StageA" in outs[1][1]


# -- end to end: a loopback agent killed mid-run -----------------------------------------


def _agent(port: int, name: str, cpus: float, extra: dict) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(REPO), "CURATE_ENGINE_TOKEN": "loss-secret", **extra}
    return subprocess.Popen([sys.executable, "-m", "cosmos_curate_tpu_torch.engine.remote_agent", "--driver",
                             f"127.0.0.1:{port}", "--node-id", name, "--num-cpus", str(cpus)], env=env, cwd=REPO,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _plane_run(monkeypatch, agents: dict) -> tuple:
    """A two-stage run on two loopback agents; returns (values, runner,
    agent exit codes). Every agent is killed on the way out."""
    port = free_port()
    monkeypatch.setenv("CURATE_ENGINE_TOKEN", "loss-secret")
    monkeypatch.setenv("CURATE_ENGINE_DRIVER_PORT", str(port))
    monkeypatch.setenv("CURATE_ENGINE_WAIT_NODES", str(len(agents)))
    monkeypatch.setenv("CURATE_ENGINE_WAIT_S", "60")
    procs = {name: _agent(port, name, cpus, extra) for name, (cpus, extra) in agents.items()}
    try:
        runner = trunner.StreamingRunner(poll_interval_s=0.01)
        out = runner.run(PipelineSpec(
            input_data=[ts.Item(value=i) for i in range(12)],
            stages=[StageSpec(ts.NodeStampStage(0.2), num_workers=2), StageSpec(ts.AddStage(), num_workers=1)],
            config=PipelineConfig(num_cpus=0.1, return_last_stage_outputs=True)))
        codes = {name: p.wait(timeout=60) for name, p in procs.items()}
        return sorted(t.value for t in out), runner, codes
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def test_agent_kill_reconstructs_and_matches_the_unfaulted_run(monkeypatch, tmp_path):
    monkeypatch.setenv("CURATE_PREWARM", "0")
    monkeypatch.setenv("CURATE_DLQ_DIR", str(tmp_path / "dlq"))
    monkeypatch.delenv("CURATE_RUNNER", raising=False)
    plain, _, codes = _plane_run(monkeypatch, {"agent-a": (2, {}), "agent-b": (6, {})})
    assert codes == {"agent-a": 0, "agent-b": 0}
    kill = tchaos.FaultPlan(rules=(tchaos.FaultRule(site=tchaos.SITE_AGENT_KILL, kind="crash", count=1,
                                                    worker_re="^agent-b$"),))
    faulted, runner, codes = _plane_run(monkeypatch, {
        "agent-a": (2, {}), "agent-b": (6, {"CURATE_WORKER_ID": "agent-b", tchaos.CHAOS_ENV: kill.to_json()})})
    assert faulted == plain == [i + 2 for i in range(12)]
    assert codes == {"agent-a": 0, "agent-b": kill.rules[0].exit_code}
    assert [e["node"] for e in runner.node_events] == ["agent-b"]
    assert runner.objects_reconstructed > 0
    assert sum(c["dead_lettered"] for c in runner.stage_counts.values()) == 0 and runner.dlq.recorded == 0
    assert not (tmp_path / "dlq").exists()
