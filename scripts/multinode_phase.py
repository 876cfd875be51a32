"""``chip_smoke.py``'s ``multinode`` phase, which ``chip_smoke.py`` runs after
its ``remote`` phase on the split phase's corpus, or alone on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/multinode_phase.py

Alone, it builds the kernels, checks flash at ``chip_smoke.FLASH_CASES`` and
writes the first ``MULTINODE_VIDEOS`` videos of the split corpus. Every run
has run A's settings (``chip_smoke.split_args``) on those videos; every
kernel's launch counter is zeroed just before a run and read just after it,
in the process that launches (a node writes its own counts to a result
file). The kernels are built once, here, before any node
starts: the nodes load the built libraries. One JSON line, ``multinode``:

1. **one node**: ``run_split`` in this process through the default runner,
   the reference every other run is held to (clips by uuid, which derives
   from the video's path and the span, metas equal, embeddings within
   ``EMBED_BOUND``, the same files).
2. **partition**: two node processes (``CURATE_NUM_NODES=2``, ranks 0 and
   1, no coordinator) released at one moment (a barrier file, once both
   have imported torch and the port), both on the one card; then
   ``cosmos_curate_tpu_torch.cli.main local merge-summaries``. The nodes'
   videos add up to the corpus and cover it (so they are disjoint), the
   merged counts are the nodes' sums, every clip is the one-node run's, a
   resumed discovery finds nothing, and flash launched in both nodes.
3. **work stealing**: the same two node processes, released again, with
   ``CURATE_WORK_STEALING=1``: every video processed once, the files those
   of the partition run. Its wall holds one 15 s linger poll of the
   reference's protocol (``run_with_stealing``'s ``poll_s``): the node
   that finishes first waits on its peer's claim.
4. **cross-node plane**: this process is the driver (``CURATE_RUNNER=engine``,
   ``CURATE_ENGINE_DRIVER_PORT``, ``CURATE_ENGINE_TOKEN``,
   ``CURATE_ENGINE_WAIT_NODES=1``, 0.1 CPUs of its own) and one loopback
   agent joins through ``cosmos_curate_tpu_torch.cli.main agent``, offering
   room for every CPU stage's first worker (at least 8 CPUs). The
   per-node planner puts every CPU stage on the agent, the embed stage
   stays on the driver's card and launches flash, the outputs are the
   one-node run's, and the traced run's report is one connected trace with
   the agent's worker spans in it (driver and agent share
   ``CURATE_TRACE_DIR``). Reported: the bytes moved over the object channel
   and the prefetch overlap (hits among the driver-bound inputs, hit wait
   against transfer seconds).
5. **node loss**: two loopback agents (``agent-0`` with 2 CPUs, ``agent-1``
   with 6, so the planner puts the first stages on ``agent-1``); chaos
   ``agent.kill`` (``kind=crash``, ``worker_re`` pinned to ``agent-1``)
   kills ``agent-1`` right after it relays its first result. The run
   completes, its clips are the one-node run's,
   ``pipeline_objects_reconstructed_total`` rises and no batch is
   dead-lettered.

Every node and agent process is killed in a ``finally`` and every wait has a
timeout; a node, agent or check that fails makes the phase raise. Reported
beside every run's wall: the one-node run's, workers by node, a worker's
spawn-to-ready seconds, and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# a spawned child (the corpus writers, the engine's workers) imports this
# script again as ``__mp_main__`` and runs none of its device code
if __name__ != "__mp_main__":
    import torch

REPO = Path(__file__).resolve().parents[1]
SEED = 19
MULTINODE_VIDEOS = 2
NODE_TIMEOUT_S = 300
AGENT_TIMEOUT_S = 60
TOKEN = "multinode-phase-secret"
SKIP_FILES = ("summary", "work_claims/", "report/", "profile/")


def free_port() -> int:
    """A port the kernel just handed out for 127.0.0.1 (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def node_main(spec: dict) -> int:
    """One node of a multi-node run, in its own process: the env contract
    comes from the parent. For each of ``spec["runs"]`` in turn: waits at
    the run's barrier, sets the run's extra environment, runs ``run_split``
    with every launch counter zeroed just before, and writes its result
    file (wall, counts, this process's launches)."""
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    import pyarrow.parquet  # noqa: F401  (main thread first: see remote_phase.main)

    import chip_smoke as cs
    from cosmos_curate_tpu_torch.ops import kernels
    from cosmos_curate_tpu_torch.pipelines.video import split

    barrier = Path(spec["barrier"])
    rank = os.environ["CURATE_NODE_RANK"]
    ks = kernels()
    for i, run in enumerate(spec["runs"]):
        (barrier / f"ready-{i}-{rank}").touch()
        deadline = time.monotonic() + NODE_TIMEOUT_S
        while not (barrier / f"go-{i}").exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"run {i}: the other node never became ready")
            time.sleep(0.01)
        os.environ.update(run["env"])
        a = cs.split_args(Path(spec["videos"]), Path(run["out"]), device=spec["device"])
        for k in ks.values():
            k.launches = 0
        t0 = time.monotonic()
        summary = split.run_split(a)
        if spec["device"] == "cuda":
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        result = barrier / f"result-{i}-{rank}.json"
        result.with_suffix(".tmp").write_text(json.dumps({
            "rank": int(rank), "wall_s": wall, "num_videos": summary["num_videos"],
            "num_clips": summary["num_clips"], "launches": {name: k.launches for name, k in ks.items()}}))
        result.with_suffix(".tmp").replace(result)
    return 0


def run_nodes(node_cmd: list[str], videos: Path, runs: list[tuple[Path, dict]], device: str) -> list[dict]:
    """Two node processes, started once, run each of ``runs`` (an output
    root and the run's extra environment) in turn, released at one moment
    for each; a run's wall is from its release to the last node's result.
    Their output goes to files: a node blocked on a full pipe would stall a
    stealing peer that waits for its claims."""
    barrier = runs[0][0].parent / f"{runs[0][0].name}_nodes"
    barrier.mkdir(parents=True)
    procs = []
    t0 = time.monotonic()

    def tail(rank: int) -> str:
        return (barrier / f"node{rank}.err").read_text()[-4000:]

    def wait_for(name: str, what: str) -> None:
        """Until both nodes' ``name`` (with ``{r}``, the rank) exists; a
        node that exits without its own raises."""
        deadline = time.monotonic() + NODE_TIMEOUT_S
        while not all((barrier / name.format(r=r)).exists() for r in (0, 1)):
            for rank, p in enumerate(procs):
                if p.poll() is not None and not (barrier / name.format(r=rank)).exists():
                    raise RuntimeError(f"node {rank} exited before {what} ({p.returncode}):\n{tail(rank)}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"the nodes never reached {what}")
            time.sleep(0.01)

    try:
        spec = {"videos": str(videos), "device": device, "barrier": str(barrier),
                "runs": [{"out": str(out), "env": env} for out, env in runs]}
        for rank in (0, 1):
            env = {**os.environ, "CURATE_NUM_NODES": "2", "CURATE_NODE_RANK": str(rank), "PYTHONPATH": str(REPO)}
            env.pop("CURATE_COORDINATOR_ADDRESS", None)  # partition mode: no process group
            env.pop("CURATE_RUNNER", None)
            with open(barrier / f"node{rank}.out", "w") as o, open(barrier / f"node{rank}.err", "w") as e:
                procs.append(subprocess.Popen([*node_cmd, json.dumps(spec)], env=env, cwd=REPO, stdout=o, stderr=e))
        records = []
        for i in range(len(runs)):
            wait_for(f"ready-{i}-{{r}}", f"run {i}'s barrier")
            ready_s = time.monotonic() - t0
            (barrier / f"go-{i}").touch()
            t_go = time.monotonic()
            wait_for(f"result-{i}-{{r}}.json", f"run {i}'s end")
            wall = time.monotonic() - t_go
            nodes = {r: json.loads((barrier / f"result-{i}-{r}.json").read_text()) for r in (0, 1)}
            # the processes' start (torch, the CUDA context, the port) is the first run's alone
            records.append({"nodes": nodes, "wall_s": wall, **({"start_to_barrier_s": ready_s} if i == 0 else {})})
        for rank, p in enumerate(procs):
            p.wait(timeout=NODE_TIMEOUT_S)
            assert p.returncode == 0, f"node {rank} failed ({p.returncode}):\n{tail(rank)}"
        return records
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


@contextlib.contextmanager
def running_agents(agents: dict[str, dict], port: int, logs: Path):
    """Loopback node agents through the port's ``agent`` command, each with
    its own extra environment; killed on the way out, every wait bounded."""
    procs = {}
    try:
        for name, extra in agents.items():
            env = {**os.environ, "PYTHONPATH": str(REPO), **extra["env"]}
            log = open(logs / f"{name}.log", "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", "agent", "--driver", f"127.0.0.1:{port}",
                 "--node-id", name, "--num-cpus", str(extra["cpus"])],
                env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT), log)
        yield procs
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=AGENT_TIMEOUT_S)
            log.close()


def output_files(out: Path) -> set[str]:
    return {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()
            and not str(p.relative_to(out)).startswith(SKIP_FILES)}


def held_to_one_node(cs, out: Path, ref: dict, label: str) -> float:
    """The run's clips, metas and files are the one-node run's, its
    embeddings within ``EMBED_BOUND``; returns the largest difference."""
    metas, embs, _ = cs.split_outputs(out, ref["model"])
    assert metas == ref["metas"], f"{label}: clips or metas differ from the one-node run"
    assert set(embs) == set(ref["embs"]), f"{label}: embedded clips differ"
    diff = max(float(np.abs(embs[u] - ref["embs"][u]).max()) for u in embs)
    assert diff <= cs.EMBED_BOUND, f"{label}: embeddings {diff} from the one-node run's"
    assert output_files(out) == ref["files"], f"{label}: output files differ"
    return diff


def reconstructed_total() -> float:
    from cosmos_curate_tpu_torch.engine.metrics import get_metrics

    m = get_metrics()
    if not m.enabled:
        return float("nan")
    return sum(s.value for metric in m.registry.collect() if metric.name == "pipeline_objects_reconstructed"
               for s in metric.samples if s.name == "pipeline_objects_reconstructed_total")


def engine_record(runner, run: dict, one_wall: float) -> dict:
    return dict(wall_s=run["wall"], over_one_node=run["wall"] / one_wall, launches=run["launches"],
                workers_by_node=runner.node_plan, remote=runner.remote_stats, object_plane=runner.object_plane,
                spawn_to_ready_s=sorted(runner.worker_ready_s), stage_counts=runner.stage_counts)


def drive_multinode(cs, dev, root: Path, corpus: list[Path], node_cmd: list[str]) -> dict:
    from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig
    from cosmos_curate_tpu_torch.core.runner import default_runner
    from cosmos_curate_tpu_torch.pipelines.video import split
    from cosmos_curate_tpu_torch.pipelines.video.input_discovery import discover_split_tasks
    from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage

    device = torch.device(dev).type
    stage_classes = (split.VideoDownloadStage, split.FixedStrideExtractorStage, split.ClipTranscodingStage,
                     split.ClipFrameExtractionStage, split.ClipEmbeddingStage, ClipWriterStage)
    videos = cs.subset(root, corpus, "videos_multinode", MULTINODE_VIDEOS)
    base = {"CURATE_RUNNER": None, "CURATE_ENGINE_DRIVER_PORT": None, "CURATE_NUM_NODES": None,
            "CURATE_NODE_RANK": None, "CURATE_WORK_STEALING": None, "CURATE_COORDINATOR_ADDRESS": None}
    rec: dict = {"videos": MULTINODE_VIDEOS}
    with cs.patched_environ(base):
        # 1. one node, in this process: the reference of every other run
        one = cs.split_run(dev, cs.split_args(videos, root / "mn_one", device=device), default_runner(),
                           stage_classes)
        model = next(p.name for p in (root / "mn_one" / "embeddings").iterdir())
        metas, embs, _ = cs.split_outputs(root / "mn_one", model)
        ref = {"model": model, "metas": metas, "embs": embs, "files": output_files(root / "mn_one")}
        n_clips = one["summary"]["num_clips"]
        assert n_clips > 0 and one["summary"]["num_videos"] == MULTINODE_VIDEOS, one["summary"]
        rec["one_node"] = {"wall_s": one["wall"], "clips": n_clips, "launches": one["launches"]}
        shapes = set(one["flash_shapes"])

        # 2. partition: two nodes at once, then merge-summaries
        # the same two node processes then run the stealing run (3.)
        out_p, out_s = root / "mn_partition", root / "mn_stealing"
        part, steal = run_nodes(node_cmd, videos, [(out_p, {}), (out_s, {"CURATE_WORK_STEALING": "1"})], device)
        s0 = json.loads((out_p / "summary.json").read_text())
        s1 = json.loads((out_p / "summary-node1.json").read_text())
        assert s0["num_videos"] >= 1 and s1["num_videos"] >= 1, (s0, s1)
        # the videos add up to the corpus and (below) cover it: disjoint
        assert s0["num_videos"] + s1["num_videos"] == MULTINODE_VIDEOS, (s0, s1)
        t0 = time.monotonic()
        merge = subprocess.run([sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", "local", "merge-summaries",
                                "--output-path", str(out_p)], cwd=REPO, capture_output=True, text=True, timeout=120)
        merge_s = time.monotonic() - t0
        assert merge.returncode == 0, merge.stdout[-2000:] + merge.stderr[-3000:]
        merged = json.loads((out_p / "summary-merged.json").read_text())
        for key in ("num_videos", "num_clips", "num_transcoded", "num_with_embeddings"):
            assert merged[key] == s0[key] + s1[key], (key, merged, s0, s1)
        assert merged["num_clips"] == n_clips and merged["merged_from"] == ["summary-node1.json", "summary.json"]
        part_diff = held_to_one_node(cs, out_p, ref, "partition")
        resumed = discover_split_tasks(str(videos), str(out_p))
        assert resumed == [], f"partition: a resumed pass discovers {len(resumed)} video(s)"
        rec["partition"] = {**part, "merge_s": merge_s, "merged": {k: merged[k] for k in (
            "num_videos", "num_clips", "num_chips", "pipeline_run_time_s")}, "max_abs_embedding_diff": part_diff,
            "resumed_videos": 0}

        # 3. work stealing: the same two nodes on the shared claim ledger
        s0 = json.loads((out_s / "summary.json").read_text())
        s1 = json.loads((out_s / "summary-node1.json").read_text())
        # a duplicated claim would count its video twice
        assert s0["num_videos"] + s1["num_videos"] == MULTINODE_VIDEOS, (s0, s1)
        claims = sorted(p.name for p in (out_s / "work_claims").iterdir())
        assert len(claims) == MULTINODE_VIDEOS, claims
        assert output_files(out_s) == output_files(out_p), "stealing: files differ from the partition run's"
        steal_diff = held_to_one_node(cs, out_s, ref, "stealing")
        rec["stealing"] = {**steal, "claims": len(claims), "max_abs_embedding_diff": steal_diff,
                           "videos_by_rank": [s0["num_videos"], s1["num_videos"]]}

        # 4. the cross-node plane: this process drives, one agent joins
        port = free_port()
        trace_dir = root / "mn_traces"
        plane_env = {"CURATE_RUNNER": "engine", "CURATE_ENGINE_DRIVER_PORT": str(port), "CURATE_ENGINE_TOKEN": TOKEN,
                     "CURATE_ENGINE_WAIT_NODES": "1", "CURATE_ENGINE_WAIT_S": str(AGENT_TIMEOUT_S),
                     "CURATE_PREWARM": "0", "CURATE_TRACE_DIR": str(trace_dir)}
        cfg = PipelineConfig(num_cpus=0.1)
        # the agent offers every CPU stage's first worker room (the driver
        # has 0.1 CPUs): the planner then has one place for each
        cpu_need = sum(s.resources.cpus for s in split.assemble_stages(cs.split_args(videos, root / "mn_x"))
                       if not s.resources.uses_gpu)
        agent_cpus = max(8, math.ceil(cpu_need))
        with cs.patched_environ(plane_env), running_agents(
                {"agent-0": {"cpus": agent_cpus, "env": {"CURATE_TRACING": "1"}}}, port, root) as agents:
            runner = default_runner()
            out_x = root / "mn_plane"
            plane = cs.split_run(dev, cs.split_args(videos, out_x, device=device, tracing=True), runner,
                                 stage_classes, config=cfg)
            # the run's end says Bye: the agent leaves with exit code 0
            codes = {name: p.wait(timeout=AGENT_TIMEOUT_S) for name, (p, _) in agents.items()}
            assert codes == {"agent-0": 0}, f"cross-node plane: agent exit codes {codes}"
        report = json.loads((out_x / "report" / "run_report.json").read_text())
        assert report["connected"], f"cross-node plane: {len(report['trace_ids'])} trace ids"
        agent_spans = sum(1 for f in (out_x / "profile").rglob("*.ndjson") for line in f.read_text().splitlines()
                          if '"worker_id"' in line and '"stage.' in line)
        plan = runner.node_plan
        embed_name = next(n for n in plan if "Embedding" in n)
        cpu_stages = {n: c for n, c in plan.items() if n != embed_name}
        rec["plane"] = {**engine_record(runner, plane, one["wall"]), "worker_spans": agent_spans, "agent_cpus": agent_cpus,
                        "trace_ids": len(report["trace_ids"]), "span_count": report["span_count"]}
        rec["plane"]["max_abs_embedding_diff"] = held_to_one_node(cs, out_x, ref, "cross-node plane")
        op = runner.object_plane
        moved = sum(v.get("fetch_bytes", 0) + v.get("prefetch_bytes", 0) for v in op.values())
        hits = sum(v.get("prefetch_hits", 0) for v in op.values())
        misses = sum(v.get("prefetch_misses", 0) for v in op.values())
        rec["plane"]["object_channel"] = {
            "bytes_moved": moved, "prefetch_hits": hits, "prefetch_misses": misses,
            "prefetch_overlap": hits / (hits + misses) if hits + misses else None,
            "prefetch_hit_wait_s": sum(v.get("prefetch_hit_wait_s", 0.0) for v in op.values()),
            "prefetch_transfer_s": sum(v.get("prefetch_transfer_s", 0.0) for v in op.values()),
            "demand_fetch_wait_s": sum(v.get("fetch_wait_s", 0.0) for v in op.values())}
        rec["plane"]["cpu_stage_nodes"] = cpu_stages
        rec["plane"]["embed_stage_nodes"] = plan[embed_name]
        shapes |= plane["flash_shapes"]

        # 5. node loss: agent-1 dies right after relaying its first result
        from cosmos_curate_tpu_torch import chaos

        port = free_port()
        kill = chaos.FaultPlan(seed=SEED, rules=(chaos.FaultRule(site=chaos.SITE_AGENT_KILL, kind="crash", count=1,
                                                                 worker_re="^agent-1$"),))
        loss_env = {**plane_env, "CURATE_ENGINE_DRIVER_PORT": str(port), "CURATE_ENGINE_WAIT_NODES": "2",
                    "CURATE_TRACE_DIR": None}
        before = reconstructed_total()
        with cs.patched_environ(loss_env), running_agents(
                {"agent-0": {"cpus": 2, "env": {}},
                 "agent-1": {"cpus": 6, "env": {"CURATE_WORKER_ID": "agent-1", chaos.CHAOS_ENV: kill.to_json()}}},
                port, root) as agents:
            runner = default_runner()
            out_l = root / "mn_loss"
            loss = cs.split_run(dev, cs.split_args(videos, out_l, device=device), runner, stage_classes, config=cfg)
            killed = agents["agent-1"][0]
            killed.wait(timeout=AGENT_TIMEOUT_S)
            exit_codes = {name: p.poll() for name, (p, _) in agents.items()}
        assert exit_codes["agent-1"] == kill.rules[0].exit_code, f"agent-1 was not killed: {exit_codes}"
        recon = reconstructed_total() - before
        dead = sum(c["dead_lettered"] for c in runner.stage_counts.values())
        assert runner.node_events and runner.node_events[0]["node"] == "agent-1", runner.node_events
        assert runner.objects_reconstructed > 0 and recon > 0, (runner.objects_reconstructed, recon)
        assert dead == 0 and (runner.dlq is None or runner.dlq.recorded == 0), f"{dead} batch(es) dead-lettered"
        rec["node_loss"] = {**engine_record(runner, loss, one["wall"]), "node_events": runner.node_events,
                            "objects_reconstructed": runner.objects_reconstructed,
                            "pipeline_objects_reconstructed_total": recon,
                            "reconstruction_s": runner.reconstruction_seconds, "dead_lettered": dead,
                            "agent_exit_codes": exit_codes}
        rec["node_loss"]["max_abs_embedding_diff"] = held_to_one_node(cs, out_l, ref, "node loss")
        shapes |= loss["flash_shapes"]
    rec["flash_shapes"] = shapes
    return rec


def check_launches(rec: dict) -> dict:
    """Flash launched in every node of both multi-node runs, on the driver of
    the cross-node plane and of the node-loss run."""
    per = {"one_node": rec["one_node"]["launches"]["flash"]}
    for run in ("partition", "stealing"):
        for rank, node in rec[run]["nodes"].items():
            per[f"{run}_node{rank}"] = node["launches"]["flash"]
    per["plane_driver"] = rec["plane"]["launches"]["flash"]
    per["node_loss_driver"] = rec["node_loss"]["launches"]["flash"]
    for where, n in per.items():
        assert n > 0, f"multinode: flash was not launched in {where}"
    for name, nodes in rec["plane"]["cpu_stage_nodes"].items():
        assert set(nodes) == {"agent-0"}, f"cross-node plane: {name} placed on {nodes}"
    assert set(rec["plane"]["embed_stage_nodes"]) == {""}, rec["plane"]["embed_stage_nodes"]
    assert rec["plane"]["worker_spans"] > 0, "cross-node plane: no worker span reached the trace"
    return per


def run(cs, dev, timer, root: Path, corpus: list[Path]) -> dict:
    """The phase, its line emitted as it ends; returns the record."""
    t0 = time.monotonic()
    node_cmd = [sys.executable, str(Path(__file__).resolve()), "--node"]
    record = drive_multinode(cs, dev, root, corpus, node_cmd)
    record["flash_launches"] = check_launches(record)
    record["flash_checked_here"] = cs.check_new_flash_shapes(timer, record.pop("flash_shapes"), SEED)
    record["launches"] = {name: sum(r["launches"][name] for r in (record["plane"], record["node_loss"]))
                          + sum(n["launches"][name] for run in ("partition", "stealing")
                                for n in record[run]["nodes"].values())
                          for name in record["one_node"]["launches"]}
    record["phase_s"] = time.monotonic() - t0
    record["card"] = cs.card_line()
    cs.emit({"phase": "multinode", **record})
    print(f"multinode: one node {record['one_node']['wall_s']:.3f} s; partition {record['partition']['wall_s']:.3f} s; "
          f"stealing {record['stealing']['wall_s']:.3f} s; plane {record['plane']['wall_s']:.3f} s; node loss "
          f"{record['node_loss']['wall_s']:.3f} s ({record['node_loss']['objects_reconstructed']} reconstructed); "
          f"phase {record['phase_s']:.1f} s", flush=True)
    return record


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--node":
        return node_main(json.loads(sys.argv[2]))
    if not torch.cuda.is_available():
        print("multinode_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import pyarrow.parquet  # noqa: F401  (main thread first: see remote_phase.main)

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    timer, build_s = cs.phase_prologue(dev)
    with cs.split_corpus(MULTINODE_VIDEOS) as (root, corpus, corpus_s):
        cs.emit({"phase": "multinode_prologue", "build_s": build_s, "corpus_build_s": corpus_s})
        run(cs, dev, timer, root, corpus)
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
