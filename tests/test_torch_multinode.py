"""Port parity: multi-node runs (``parallel/distributed.py``,
``parallel/work_stealing.py``, ``utils/summary.py merge_node_summaries`` and
``run_split``'s multi-node wrap).

- The environment contract: ``node_rank_and_count`` and
  ``partition_tasks_for_node`` give the reference's rank, count and slice
  for every (N, rank) up to 4 and for ``SLURM_NODEID``; without a
  coordinator no process group is joined; with one, two processes join one
  gloo group (an ``all_reduce`` across them).
- ``merge_node_summaries``: the same merged JSON as the reference's from the
  same per-node summaries, less the timing keys.
- The claim ledger: on one ledger directory the port makes the reference's
  sequence of claims (batch sizes, rank offsets, exclusivity, TTL expiry
  under a pinned clock), each package honours the other's fresh claims,
  and ``run_with_stealing`` runs the reference's batches.
- The fault this slice repairs: two ``run_split(device="cpu")`` nodes under
  ``CURATE_NUM_NODES=2`` in two subprocesses (released at one moment by a
  barrier file), on two tiny fixture videos, give the JAX package's clip
  uuids, ``summary.json`` / ``summary-node1.json`` counts and merged
  summary (through each package's ``local merge-summaries``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from cosmos_curate_tpu.cli import main as jmain
from cosmos_curate_tpu.parallel import distributed as jdist
from cosmos_curate_tpu.parallel import work_stealing as jsteal
from cosmos_curate_tpu.utils import summary as jsummary
from cosmos_curate_tpu_torch.cli import main as tmain
from cosmos_curate_tpu_torch.parallel import distributed as tdist
from cosmos_curate_tpu_torch.parallel import work_stealing as tsteal
from cosmos_curate_tpu_torch.utils import summary as tsummary
from tests.fixtures.media import make_scene_video
from tests.fixtures.observability import observability_state  # noqa: F401  (autouse)
from tests.fixtures.ports import free_port

REPO = Path(__file__).resolve().parents[1]
CLOCK_KEYS = ("timestamp", "pipeline_run_time_s", "video_hours_per_day_per_chip")
CONTRACT = ("CURATE_NUM_NODES", "CURATE_NODE_RANK", "SLURM_NODEID", "CURATE_COORDINATOR_ADDRESS",
            "CURATE_WORK_STEALING")


@pytest.fixture(autouse=True)
def _no_contract(monkeypatch):
    for k in CONTRACT:
        monkeypatch.delenv(k, raising=False)



# -- the environment contract -----------------------------------------------------


@pytest.mark.parametrize("n,rank", [(n, r) for n in (1, 2, 3, 4) for r in range(n)],
                         ids=[f"n{n}-r{r}" for n in (1, 2, 3, 4) for r in range(n)])
def test_partition_matches_jax(n, rank, monkeypatch):
    monkeypatch.setenv("CURATE_NUM_NODES", str(n))
    monkeypatch.setenv("CURATE_NODE_RANK", str(rank))
    tasks = [f"v{i}.mp4" for i in range(11)]
    got = tdist.partition_tasks_for_node(list(tasks))
    assert got == jdist.partition_tasks_for_node(list(tasks))
    assert tdist.node_rank_and_count() == jdist.node_rank_and_count() == (rank, n)
    assert got == tasks[rank::n]


@pytest.mark.parametrize("env", [{}, {"SLURM_NODEID": "2", "CURATE_NUM_NODES": "3"},
                                 {"CURATE_NODE_RANK": "1", "SLURM_NODEID": "2", "CURATE_NUM_NODES": "3"},
                                 {"CURATE_NUM_NODES": "0"}], ids=["unset", "slurm", "explicit-wins", "zero-nodes"])
def test_rank_and_count_match_jax(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tdist.node_rank_and_count() == jdist.node_rank_and_count()
    assert tdist.partition_tasks_for_node([1, 2, 3, 4, 5]) == jdist.partition_tasks_for_node([1, 2, 3, 4, 5])


def test_partition_mode_joins_no_group(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setenv("CURATE_NUM_NODES", "2")
    monkeypatch.setenv("CURATE_NODE_RANK", "1")
    assert tdist.maybe_initialize_distributed() is False
    monkeypatch.setenv("CURATE_COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("CURATE_NUM_NODES", "1")
    assert tdist.maybe_initialize_distributed() is False  # one node: nothing to join
    assert not dist.is_initialized()


_GLOO = """
import os, torch, torch.distributed as dist
from cosmos_curate_tpu_torch.parallel.distributed import maybe_initialize_distributed
assert maybe_initialize_distributed() and maybe_initialize_distributed()
t = torch.tensor([float(os.environ["CURATE_NODE_RANK"]) + 1.0])
dist.all_reduce(t)
print("GLOO", dist.get_backend(), dist.get_world_size(), dist.get_rank(), float(t[0]))
dist.destroy_process_group()
"""


def test_coordinator_joins_a_gloo_group():
    addr = f"127.0.0.1:{free_port()}"
    procs = []
    try:
        for rank in (0, 1):
            env = {**os.environ, "PYTHONPATH": str(REPO), "CURATE_COORDINATOR_ADDRESS": addr,
                   "CURATE_NUM_NODES": "2", "CURATE_NODE_RANK": str(rank)}
            procs.append(subprocess.Popen([sys.executable, "-c", _GLOO], env=env, cwd=REPO, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for (out, err), p in zip(outs, procs):
        assert p.returncode == 0, err[-3000:]
    assert sorted(o.split("GLOO ")[1].split() for o, _ in outs) == [["gloo", "2", "0", "3.0"],
                                                                    ["gloo", "2", "1", "3.0"]]


# -- merge_node_summaries ------------------------------------------------------------


def _summary(i: int, **kw) -> dict:
    base = {"timestamp": 1000.0 + i, "num_videos": 2 + i, "total_video_duration_s": 8.5 * (i + 1),
            "pipeline_run_time_s": 10.0 + 3 * i, "num_chips": 1, "video_hours_per_day_per_chip": 1.0,
            "num_errors": i % 2, "num_clips": 7 + i, "num_filtered_by_motion": 0, "num_filtered_by_aesthetic": i,
            "num_filtered_by_text": 0, "num_filtered_by_semantic": 0, "num_filtered_by_dedup": 0,
            "num_transcoded": 7 + i, "num_with_embeddings": 7 + i, "num_with_captions": 0, "num_with_webp": 0,
            "total_clip_duration_s": 14.0 + i, "max_clip_duration_s": 2.0 + 0.5 * i}
    return {**base, **kw}


MERGES = {
    "two-nodes": {"summary.json": _summary(0), "summary-node1.json": _summary(1)},
    "four-nodes": {"summary.json": _summary(0), **{f"summary-node{r}.json": _summary(r) for r in (1, 2, 3)}},
    "provenance": {"summary.json": _summary(0, weights_provenance={"clip": "seeded"}),
                   "summary-node1.json": _summary(1, weights_provenance={"t5": "staged"})},
    "one-node": {"summary.json": _summary(0)},
    "stale-merge-ignored": {"summary.json": _summary(0), "summary-node1.json": _summary(1),
                            "summary-merged.json": _summary(9)},
    "missing-keys": {"summary.json": {"num_videos": 1, "pipeline_run_time_s": 3.0},
                     "summary-node1.json": {"num_clips": 4, "pipeline_run_time_s": 5.0}},
    "empty": {},
}


@pytest.mark.parametrize("case", list(MERGES), ids=list(MERGES))
def test_merge_node_summaries_matches_jax(case, tmp_path):
    merged = []
    for name, mod in (("jax", jsummary), ("torch", tsummary)):
        root = tmp_path / name
        root.mkdir()
        for fname, doc in MERGES[case].items():
            (root / fname).write_text(json.dumps(doc))
        out = mod.merge_node_summaries(str(root))
        on_disk = json.loads((root / "summary-merged.json").read_text()) if out is not None else None
        assert out == on_disk
        merged.append(None if out is None else {k: v for k, v in out.items() if k not in CLOCK_KEYS})
    assert merged[1] == merged[0]
    if case == "two-nodes":
        assert merged[1]["num_clips"] == 15 and merged[1]["merged_from"] == ["summary-node1.json", "summary.json"]


# -- the claim ledger ------------------------------------------------------------------


class _Clock:
    def __init__(self, t: float) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def _claims(mod, root: str, steps: list[tuple], clock: _Clock) -> list:
    out = []
    tasks = [f"t{i}" for i in range(6)]
    for rank, batch, ttl, at in steps:
        clock.t = at
        out.append(mod.claim_next_batch(tasks, root, record_id=str, batch=batch, ttl_s=ttl, rank=rank))
    return out


# (rank, batch, ttl, time) claim steps
LEDGERS = {
    "exclusive": [(0, 6, 1800.0, 1000.0), (1, 6, 1800.0, 1001.0)],
    "rank-offsets": [(0, 2, 1800.0, 1000.0), (1, 2, 1800.0, 1000.0), (2, 2, 1800.0, 1000.0),
                     (0, 2, 1800.0, 1000.0)],
    "ttl-expiry": [(0, 3, 10.0, 1000.0), (1, 6, 10.0, 1005.0), (1, 6, 10.0, 1011.0), (0, 6, 10.0, 1012.0)],
    "own-stale-claims": [(1, 2, 5.0, 1000.0), (1, 2, 5.0, 1002.0), (1, 2, 5.0, 1010.0)],
}


@pytest.mark.parametrize("case", list(LEDGERS), ids=list(LEDGERS))
def test_claim_sequence_matches_jax(case, tmp_path, monkeypatch):
    clock = _Clock(0.0)
    monkeypatch.setattr(time, "time", clock)
    got = _claims(tsteal, str(tmp_path / "torch"), LEDGERS[case], clock)
    assert got == _claims(jsteal, str(tmp_path / "jax"), LEDGERS[case], clock)
    ledgers = [{p.name: json.loads(p.read_text()) for p in (tmp_path / pkg / "work_claims").iterdir()}
               for pkg in ("jax", "torch")]
    assert ledgers[1] == ledgers[0]


def test_each_package_honours_the_others_claims(tmp_path):
    tasks = [f"t{i}" for i in range(4)]
    root = str(tmp_path)
    assert tsteal.claim_next_batch(tasks, root, record_id=str, batch=2, rank=0) == ["t0", "t1"]
    assert jsteal.claim_next_batch(tasks, root, record_id=str, batch=4, rank=1) == ["t2", "t3"]
    assert tsteal.claim_next_batch(tasks, root, record_id=str, batch=4, rank=2) == []


def test_run_with_stealing_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("CURATE_NUM_NODES", "2")
    monkeypatch.setenv("CURATE_NODE_RANK", "1")
    monkeypatch.setenv("CURATE_WORK_STEALING", "1")
    runs = []
    for name, mod in (("jax", jsteal), ("torch", tsteal)):
        batches: list = []
        out = mod.run_with_stealing([f"v{i}" for i in range(9)], str(tmp_path / name),
                                    lambda b, seen=batches: (seen.append(list(b)), [x.upper() for x in b])[1],
                                    record_id=str, is_done=None)
        runs.append((batches, out))
    assert runs[1] == runs[0]
    assert tsteal.stealing_enabled() and sorted(runs[1][1]) == sorted(f"V{i}" for i in range(9))


def test_claim_heartbeat_refreshes_like_jax(tmp_path, monkeypatch):
    import threading

    monkeypatch.setenv("CURATE_NODE_RANK", "1")
    stamps = []
    for name, mod in (("jax", jsteal), ("torch", tsteal)):
        root = tmp_path / name
        mod.claim_next_batch(["a"], str(root), record_id=str, batch=1, rank=1)
        before = json.loads((root / "work_claims" / "a.json").read_text())
        stop = threading.Event()
        beat = threading.Thread(target=mod._heartbeat_claims, args=(str(root), ["a"], 3.0, stop), daemon=True)
        beat.start()
        time.sleep(1.4)  # the period is ttl / 3 = 1 s
        stop.set()
        beat.join(timeout=5)
        after = json.loads((root / "work_claims" / "a.json").read_text())
        stamps.append((before["rank"], after["rank"], after["ts"] > before["ts"]))
    assert stamps[1] == stamps[0] == (1, 1, True)


# -- the fault: two split nodes ----------------------------------------------------------

_NODE = """
import json, os, sys, time
from pathlib import Path
pkg, videos, out, barrier = sys.argv[1:5]
if pkg == "jax":
    from cosmos_curate_tpu.core.runner import SequentialRunner
    from cosmos_curate_tpu.pipelines.video.split import SplitPipelineArgs, run_split
    kw = {}
else:
    from cosmos_curate_tpu_torch.core.runner import SequentialRunner
    from cosmos_curate_tpu_torch.pipelines.video.split import SplitPipelineArgs, run_split
    kw = {"device": "cpu"}
args = SplitPipelineArgs(input_path=videos, output_path=out, fixed_stride_len_s=1.0, min_clip_len_s=0.5,
                         extract_fps=(4.0,), extract_resize_hw=(32, 32), num_chips=1, **kw)
rank = os.environ["CURATE_NODE_RANK"]
Path(barrier, f"ready-{pkg}-{rank}").touch()
deadline = time.monotonic() + 120
while not Path(barrier, f"go-{pkg}").exists():
    assert time.monotonic() < deadline, "the other node never became ready"
    time.sleep(0.01)
summary = run_split(args, runner=SequentialRunner())
print("NODE", json.dumps({"num_videos": summary["num_videos"], "num_clips": summary["num_clips"]}))
"""


def _two_nodes(pkg: str, videos: Path, out: Path, barrier: Path) -> list[dict]:
    procs = []
    try:
        for rank in (0, 1):
            env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu", "CURATE_NUM_NODES": "2",
                   "CURATE_NODE_RANK": str(rank), "CURATE_RUNNER": "sequential"}
            procs.append(subprocess.Popen([sys.executable, "-c", _NODE, pkg, str(videos), str(out), str(barrier)],
                                          env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        deadline = time.monotonic() + 120
        while not all((barrier / f"ready-{pkg}-{r}").exists() for r in (0, 1)):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs), "a node died at start"
            time.sleep(0.02)
        (barrier / f"go-{pkg}").touch()
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for (_, err), p in zip(outs, procs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(o.split("NODE ")[1]) for o, _ in outs]


def test_two_node_split_matches_jax(tmp_path, capsys):
    """The fault this slice repairs: under the env contract the port's nodes
    split the corpus and name their summaries as the reference's do (the
    parent tree's port ran every video on every node, and both wrote
    summary.json)."""
    videos = tmp_path / "videos"
    videos.mkdir()
    for i in range(2):
        make_scene_video(videos / f"v{i}.mp4", scene_len_frames=24, num_scenes=2, size_wh=(64, 48))
    barrier = tmp_path / "barrier"
    barrier.mkdir()
    runs = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / f"out_{pkg}"
        nodes = _two_nodes(pkg, videos, out, barrier)
        summaries = {name: json.loads((out / name).read_text()) for name in ("summary.json", "summary-node1.json")}
        main = jmain if pkg == "jax" else tmain
        assert main.main(["local", "merge-summaries", "--output-path", str(out)]) == 0
        capsys.readouterr()
        merged = json.loads((out / "summary-merged.json").read_text())
        runs[pkg] = dict(
            nodes=nodes,
            summaries={k: {f: v for f, v in s.items() if f not in CLOCK_KEYS} for k, s in summaries.items()},
            merged={k: v for k, v in merged.items() if k not in CLOCK_KEYS},
            uuids=sorted(p.stem for p in (out / "metas").rglob("*.json")),
            records=sorted(p.name for p in (out / "processed_videos").iterdir()))
    assert runs["torch"] == runs["jax"]
    nodes = runs["torch"]["nodes"]
    assert [n["num_videos"] for n in nodes] == [1, 1] and runs["torch"]["merged"]["num_videos"] == 2
    assert len(runs["torch"]["uuids"]) == runs["torch"]["merged"]["num_clips"] == sum(n["num_clips"] for n in nodes)
