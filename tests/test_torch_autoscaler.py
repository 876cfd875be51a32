"""Port parity: the pipelined runner's worker planner
(``engine/autoscaler.py``'s ``plan_allocation``) against the JAX package's.

The same ``StageScaleState`` inputs (stage costs, measured rates, queue
depths, worker bounds) and budget go through both planners; the JAX side
counts TPU chips where the port counts CUDA devices (``tpus`` /
``entire_tpu_host`` map to ``gpus`` / ``entire_gpu_host``). Plans are
integer lists: every comparison is exact.

The cases: the seven of ``tests/engine/test_autoscaler.py``, a
``hypothesis`` sweep, and two plans through each runner's own ``_plan``:
run A's stage list (bench.py's headline settings) on 8 CPUs, and a GPU
budget that the device stages' first grants overrun.
"""

from __future__ import annotations

import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cosmos_curate_tpu.core import pipelined_runner as jrunner
from cosmos_curate_tpu.core import stage as jstage
from cosmos_curate_tpu.engine import autoscaler as jauto
from cosmos_curate_tpu.pipelines.video import split as jsplit
from cosmos_curate_tpu_torch.core import pipelined_runner as trunner
from cosmos_curate_tpu_torch.core import stage as tstage
from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig
from cosmos_curate_tpu_torch.engine import autoscaler as tauto
from cosmos_curate_tpu_torch.pipelines.video import split as tsplit


def _stage_cls(stage_mod, res_kw: dict, thread_safe: bool = True):
    class S(stage_mod.Stage):
        def __init__(self, name):
            self._name = name

        @property
        def name(self):
            return self._name

        @property
        def resources(self):
            return stage_mod.Resources(**res_kw)

        @property
        def thread_safe(self):
            return thread_safe

        def process_data(self, tasks):
            return tasks

    return S


def _states(case: list[dict]) -> tuple[list, list]:
    """One stage list in both packages: each dict gives cpus, acc (the
    accelerator share), host (a whole-host claim), rate, queued, the JAX
    state's current workers (which its planner does not read) and the
    StageSpec worker bounds."""
    j, t = [], []
    for i, c in enumerate(case):
        acc, host = c.get("acc", 0.0), c.get("host", False)
        spec_kw = {k: c[k] for k in ("num_workers", "min_workers", "max_workers") if k in c}
        js = _stage_cls(jstage, dict(cpus=c.get("cpus", 1.0), tpus=acc, entire_tpu_host=host))(f"s{i}")
        ts = _stage_cls(tstage, dict(cpus=c.get("cpus", 1.0), gpus=acc, entire_gpu_host=host))(f"s{i}")
        j.append(jauto.StageScaleState(spec=jstage.StageSpec(stage=js, **spec_kw), current_workers=c.get("workers", 1),
                                       throughput_per_worker=c.get("rate"), queued=c.get("queued", 0)))
        t.append(tauto.StageScaleState(spec=tstage.StageSpec(stage=ts, **spec_kw),
                                       throughput_per_worker=c.get("rate"), queued=c.get("queued", 0)))
    return j, t


def _plans(case: list[dict], cpus: float, acc: float = 0.0) -> tuple[list[int], list[int]]:
    j, t = _states(case)
    return jauto.plan_allocation(j, jauto.Budget(cpus=cpus, tpus=acc)), tauto.plan_allocation(
        t, tauto.Budget(cpus=cpus, gpus=acc))


# the seven cases of tests/engine/test_autoscaler.py, with their checks
REFERENCE_CASES = {
    "bottleneck_gets_extra_workers": (
        [dict(rate=10.0, queued=2), dict(rate=1.0, queued=2)], 8, lambda a: a[1] > a[0] and sum(a) <= 8),
    "zero_cost_stage_terminates": ([dict(cpus=0.0, queued=100)], 4, lambda a: 1 <= a[0] <= 17),
    "queue_bias_moves_workers_to_starved_stage": (
        [dict(rate=2.0, queued=0), dict(rate=2.0, queued=50)], 6, lambda a: a[1] > a[0]),
    "throughput_shift_before": ([dict(rate=8.0, queued=0), dict(rate=1.0, queued=40)], 8, lambda a: a[1] > a[0]),
    "throughput_shift_after": (
        [dict(rate=1.0, queued=40), dict(rate=8.0, queued=0)], 8, lambda a: a[0] > a[1] and a[1] == 1),
    "drained_stage_keeps_minimum": ([dict(rate=5.0, queued=0, min_workers=2)], 8, lambda a: a == [2]),
    "unknown_rate_still_scales_on_backlog": ([dict(queued=0)], 3, lambda a: a == [3]),
    "fixed_pool_not_scaled": (
        [dict(rate=0.1, queued=99, num_workers=2), dict(rate=5.0, queued=1)], 8, lambda a: a[0] == 2),
}


@pytest.mark.parametrize("name", list(REFERENCE_CASES))
def test_plan_matches_jax_on_the_reference_cases(name):
    case, cpus, check = REFERENCE_CASES[name]
    j, t = _plans(case, cpus)
    assert t == j
    assert check(t), t


_stage = st.fixed_dictionaries(
    {
        "cpus": st.sampled_from([0.0, 0.25, 0.5, 1.0, 2.0, 3.0, 4.0]),
        "acc": st.sampled_from([0.0, 0.0, 0.25, 1.0]),
        "host": st.booleans(),
        "rate": st.one_of(st.none(), st.floats(0.05, 50.0)),
        "queued": st.integers(0, 64),
        "workers": st.integers(0, 8),
        "min_workers": st.integers(1, 3),
    },
    optional={"num_workers": st.integers(1, 4), "max_workers": st.integers(1, 12)},
)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(case=st.lists(_stage, min_size=1, max_size=8), cpus=st.sampled_from([1.0, 4.0, 8.0, 16.0, 32.0]),
       acc=st.sampled_from([0.0, 1.0, 4.0]))
def test_plan_matches_jax_on_a_sweep(case, cpus, acc):
    j, t = _plans(case, cpus, acc)
    assert t == j


def _runner_plan(runner_mod, runner, specs: list, cpus: float, auto_mod, measured: dict | None = None,
                 **budget) -> list[int]:
    """The plan a runner's own ``_plan`` makes on ``specs``: at a run's
    start (no rates, empty queues), or with ``measured`` per stage index
    (batch seconds, queued tasks)."""
    runtimes = [runner_mod._StageRuntime(i, s, runner_mod._TaskQueue(64), None) for i, s in enumerate(specs)]
    for i, (batch_s, queued) in (measured or {}).items():
        runtimes[i].samples.append((time.monotonic(), batch_s))
        runtimes[i].in_q.put_many([object()] * queued, lambda: False)
    return runner._plan(runtimes, auto_mod.Budget(cpus=cpus, **budget))


def _spec(mod, s):
    return s if isinstance(s, mod.StageSpec) else mod.StageSpec(stage=s)


RUN_A = dict(fixed_stride_len_s=1.0, min_clip_len_s=0.5, extract_fps=(8.0,), extract_resize_hw=(224, 224),
             embedding_model="video")


def test_run_a_defaults_plan_one_worker_a_stage_in_both_packages():
    """Run A's stages ask 9.75 CPUs of first grants (download 0.25, fixed
    stride 1, transcode 4, frames 3, embed 1, writer 0.5): on 8 CPUs and one
    card no stage gets a second worker, in either package."""
    j_specs = [_spec(jstage, s) for s in jsplit.assemble_stages(jsplit.SplitPipelineArgs(**RUN_A))]
    t_specs = [_spec(tstage, s) for s in tsplit.assemble_stages(tsplit.SplitPipelineArgs(device="cpu", **RUN_A))]
    assert [s.name for s in t_specs] == [s.name for s in j_specs]
    assert sum(s.stage.resources.cpus for s in t_specs) == sum(s.stage.resources.cpus for s in j_specs) == 9.75
    j = _runner_plan(jrunner, jrunner.PipelinedRunner(), j_specs, 8.0, jauto, tpus=1.0)
    t = _runner_plan(trunner, trunner.PipelinedRunner(), t_specs, 8.0, tauto, gpus=1.0)
    assert t == j == [1, 1, 1, 1, 1, 1]
    # measured rates with transcode the slowest and the only backlog: with
    # transcode_cpus=1 (8 CPUs) or 16 CPUs the planner has room, and
    # transcode fans out; the port's embed stage on the CPU claims no card
    # where the JAX one claims a chip, so each budget holds what its stages
    # claim
    measured = {0: (0.01, 0), 1: (0.01, 0), 2: (1.0, 12), 3: (0.2, 0), 4: (0.05, 0), 5: (0.01, 0)}
    plans = {}
    for kw, cpus in ((dict(transcode_cpus=1), 8.0), ({}, 16.0), (dict(transcode_cpus=1), 16.0)):
        j_specs = [_spec(jstage, s) for s in jsplit.assemble_stages(jsplit.SplitPipelineArgs(**RUN_A, **kw))]
        t_specs = [_spec(tstage, s) for s in tsplit.assemble_stages(
            tsplit.SplitPipelineArgs(device="cpu", **RUN_A, **kw))]
        j = _runner_plan(jrunner, jrunner.PipelinedRunner(thread_cap=16), j_specs, cpus, jauto, measured, tpus=1.0)
        t = _runner_plan(trunner, trunner.PipelinedRunner(thread_cap=16), t_specs, cpus, tauto, measured, gpus=0.0)
        assert t == j, (kw, cpus)
        plans[(kw.get("transcode_cpus", 4), cpus)] = t
    assert plans == {(1, 8.0): [1, 1, 2, 1, 1, 1], (4, 16.0): [1, 1, 2, 1, 1, 1],
                     (1, 16.0): [1, 1, 10, 1, 1, 1]}, plans


def test_gpu_budget_overrun_by_first_grants_plans_one_worker_everywhere():
    """One card, an embed stage claiming it and a caption stage claiming the
    whole host, between thread-safe CPU stages, on 16 CPUs: the first
    grants overrun the card, so no further grant fits the GPU budget (a CPU
    stage's zero GPU cost is checked against a negative remainder) and no
    stage fans out. The reference's behaviour, kept by the port."""
    def build(stage_mod, acc_key, host_key):
        cpu = _stage_cls(stage_mod, dict(cpus=1.0))
        embed = _stage_cls(stage_mod, {"cpus": 1.0, acc_key: 1.0}, thread_safe=False)
        caption = _stage_cls(stage_mod, {"cpus": 1.0, host_key: True}, thread_safe=False)
        return [stage_mod.StageSpec(stage=s) for s in (cpu("a"), embed("embed"), cpu("b"), caption("caption"),
                                                        cpu("c"))]

    j = _runner_plan(jrunner, jrunner.PipelinedRunner(), build(jstage, "tpus", "entire_tpu_host"), 16.0, jauto,
                     tpus=1.0)
    t = _runner_plan(trunner, trunner.PipelinedRunner(), build(tstage, "gpus", "entire_gpu_host"), 16.0, tauto,
                     gpus=1.0)
    assert t == j == [1, 1, 1, 1, 1]
    # without the device stages the same CPU stages fan out
    t_cpu = _runner_plan(trunner, trunner.PipelinedRunner(), [
        s for s in build(tstage, "gpus", "entire_gpu_host") if not s.stage.resources.uses_gpu], 16.0, tauto,
        gpus=1.0)
    assert min(t_cpu) > 1, t_cpu


def test_queue_capacity_follows_the_reference_formula():
    cfg = PipelineConfig()
    runner = trunner.PipelinedRunner()
    assert [runner._queue_capacity(w, cfg) for w in (1, 10, 11, 40)] == [16, 16, 16, 60]
    assert trunner.PipelinedRunner(queue_capacity=3)._queue_capacity(40, cfg) == 3
