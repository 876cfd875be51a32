"""Port parity: per-stage profiling (``observability/profiling.py``) and
``StageTimer`` (``observability/stage_timer.py``).

The reference's cases (tests/observability/test_observability.py,
``TestProfiling`` and ``TestStageTimer``) run through both packages on the
same toy stage, plus what the port adds: the device backend's
``torch.profiler`` trace (on the CPU: CPU activity only), stacked wrappers,
and two stages profiled at once in one process (Python 3.12's cProfile
admits one profiler per process; the port takes turns).
"""

from __future__ import annotations

import json
import re
import threading
import time
from dataclasses import dataclass, field

import cloudpickle
import numpy as np
import pytest
import torch

from cosmos_curate_tpu.core.pipeline import run_pipeline as jrun_pipeline
from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.core.stage import Stage as JStage
from cosmos_curate_tpu.core.tasks import PipelineTask as JPipelineTask
from cosmos_curate_tpu.observability import profiling as jprofiling
from cosmos_curate_tpu.observability.stage_timer import StageTimer as JStageTimer
from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.core.tasks import PipelineTask
from cosmos_curate_tpu_torch.observability import profiling
from cosmos_curate_tpu_torch.observability.stage_replay import StageSaveConfig, stage_save_wrapper
from cosmos_curate_tpu_torch.observability.stage_timer import StageTimer
from tests.fixtures.observability import observability_state  # noqa: F401


@dataclass
class Tok(PipelineTask):
    value: int = 0
    arr: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))


class Work(Stage):
    def process_data(self, tasks):
        # one torch op, so the device backend's CPU activity has an event
        bumped = torch.as_tensor(np.stack([t.arr for t in tasks])) + 1
        return [Tok(value=t.value + 1, arr=row.numpy()) for t, row in zip(tasks, bumped)]


@dataclass
class JTok(JPipelineTask):
    value: int = 0
    arr: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))


class JWork(JStage):
    @property
    def name(self) -> str:
        return "Work"

    def process_data(self, tasks):
        return [JTok(value=t.value + 1, arr=t.arr + 1) for t in tasks]


def _artifacts(root, kind: str) -> list:
    return sorted((root / kind).glob("Work-*.txt"))


@pytest.mark.parametrize("kind", ["cpu", "memory"])
def test_profile_artifacts_match_jax(kind, tmp_path):
    cfg = dict(cpu=kind == "cpu", memory=kind == "memory")
    stage = profiling.profiling_wrapper(Work(), profiling.ProfilingConfig(output_path=str(tmp_path / "port"), **cfg))
    j_stage = jprofiling.profiling_wrapper(JWork(), jprofiling.ProfilingConfig(output_path=str(tmp_path / "jax"),
                                                                               **cfg))
    out = run_pipeline([Tok(value=i) for i in range(3)], [stage], runner=SequentialRunner())
    j_out = jrun_pipeline([JTok(value=i) for i in range(3)], [j_stage], runner=JSequentialRunner())
    assert [t.value for t in out] == [t.value for t in j_out] == [1, 2, 3]  # behavior kept
    arts, j_arts = _artifacts(tmp_path / "port", kind), _artifacts(tmp_path / "jax", kind)
    assert len(arts) == len(j_arts) == 1
    assert re.sub(r"\d+", "N", arts[0].name) == re.sub(r"\d+", "N", j_arts[0].name) == "Work-N.txt"
    text, j_text = arts[0].read_text(), j_arts[0].read_text()
    if kind == "cpu":
        assert "process_data" in text and "process_data" in j_text
        assert "Ordered by: cumulative time" in text
    else:
        lines, j_lines = text.splitlines(), j_text.splitlines()
        assert len(lines) == len(j_lines) == 3  # one line a call
        assert all(re.fullmatch(r"call \d+: current=\d+ peak=\d+", ln) for ln in lines + j_lines)
    assert stage.name == "Work" and isinstance(stage, Work) and type(stage).__name__ == "ProfiledStage"


def test_device_backend_writes_a_chrome_trace(tmp_path):
    """``device=True``: a ``torch.profiler`` trace a call under
    ``<out>/device/<stage>/`` (CPU activity here; the card adds CUDA's)."""
    stage = profiling.profiling_wrapper(Work(), profiling.ProfilingConfig(device=True, output_path=str(tmp_path)))
    out = run_pipeline([Tok(value=i) for i in range(2)], [stage], runner=SequentialRunner())
    assert [t.value for t in out] == [1, 2]
    traces = sorted((tmp_path / "device" / "Work").glob("trace-*-*.json"))
    assert len(traces) == 2  # batch size 1: one trace a call
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::add" for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)  # no card, no CUDA activity
    assert not (tmp_path / "cpu").exists() and not (tmp_path / "memory").exists()


def test_stacked_wrappers_keep_the_name_and_pickle(tmp_path):
    stage = stage_save_wrapper(Work(), StageSaveConfig(output_path=str(tmp_path / "save"), sample_rate=1.0))
    profiling.profiling_wrapper(stage, profiling.ProfilingConfig(cpu=True, output_path=str(tmp_path / "prof")))
    assert stage.name == "Work" and isinstance(stage, Work)
    # the streaming engine ships stages by value: the run-time classes too
    copy = cloudpickle.loads(cloudpickle.dumps(stage))
    assert copy.name == "Work" and type(copy).__name__ == "ProfiledStage"
    run_pipeline([Tok(value=1)], [copy], runner=SequentialRunner())
    assert len(_artifacts(tmp_path / "prof", "cpu")) == 1
    assert len(list((tmp_path / "save" / "stage_inputs" / "Work").glob("batch-*.pkl"))) == 1


class Slow(Stage):
    def __init__(self, label: str):
        self.label = label
        self.overlapped = threading.Event()

    @property
    def name(self) -> str:
        return self.label

    @property
    def resources(self):
        return Resources(cpus=0.25)

    def process_data(self, tasks):
        time.sleep(0.05)
        return tasks


def test_two_stages_profiled_at_once_take_turns(tmp_path):
    """Both stages' threads profile under the pipelined runner: cProfile
    (``sys.monitoring`` since Python 3.12) admits one profiler per process,
    so unguarded overlapping calls would fail each other's batches."""
    cfg = profiling.ProfilingConfig(cpu=True, memory=True, output_path=str(tmp_path))
    stages = [profiling.profiling_wrapper(Slow(label), cfg) for label in ("A", "B")]
    runner = PipelinedRunner()
    out = run_pipeline([Tok(value=i) for i in range(6)], stages, runner=runner)
    assert sorted(t.value for t in out) == list(range(6))
    assert runner.dlq is None or runner.dlq.recorded == 0
    for label in ("A", "B"):
        assert len(list((tmp_path / "cpu").glob(f"{label}-*.txt"))) == 1
        assert len((tmp_path / "memory" / next((tmp_path / "memory").glob(f"{label}-*.txt")).name)
                   .read_text().splitlines()) == 6


@pytest.mark.parametrize("calls", [0, 1, 3])
def test_stage_timer_matches_jax(calls):
    timer, j_timer = StageTimer("s"), JStageTimer("s")
    for _ in range(calls):
        with timer.time_process():
            pass
        with j_timer.time_process():
            pass
    s, j = timer.summary(), j_timer.summary()
    assert sorted(s) == sorted(j)
    assert s["stage"] == "s" and s["count"] == calls
    if calls:
        assert s["p50_s"] >= 0 and timer.idle_s >= 0 and s["max_s"] >= s["p50_s"]
    else:
        assert s == j == {"stage": "s", "count": 0}
