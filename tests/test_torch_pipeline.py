"""Port parity: the pipeline framework (``run_pipeline``, the runners, the
pre-flight), on toy stages.

The cases of ``tests/core/test_pipelined_runner.py`` that need no video run
against the port's ``PipelinedRunner`` and ``SequentialRunner``: output-set
equivalence, retries into the dead-letter queue, backpressure, device and
unmarked stages on one worker thread, the fan-out of thread-safe stages
(its pools grow and drain, setup and destroy run once, chaos faults in a
fanned-out stage), chaos sites, clean destroy, and the default runner's
selection (the runners the port does not have raise). Two checks
cross packages: one toy stage chain gives the same output set through the
JAX package's runners and the port's, and a mis-wired pipeline raises
``PipelineValidationError`` in both. All comparisons are exact (integer
payloads).
"""

from __future__ import annotations

import threading
import time

import pytest

from cosmos_curate_tpu import chaos as jchaos
from cosmos_curate_tpu.analysis.graph_lint import PipelineValidationError as JValidationError
from cosmos_curate_tpu.core import stage as jstage
from cosmos_curate_tpu.core import tasks as jtasks
from cosmos_curate_tpu.core.pipeline import run_pipeline as jrun_pipeline
from cosmos_curate_tpu.core.pipelined_runner import PipelinedRunner as JPipelinedRunner
from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.analysis.graph_lint import PipelineValidationError
from cosmos_curate_tpu_torch.core import stage as tstage
from cosmos_curate_tpu_torch.core import tasks as ttasks
from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig, run_pipeline
from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
from cosmos_curate_tpu_torch.core.runner import SequentialRunner, default_runner
from cosmos_curate_tpu_torch.core.stage import Resources, Stage, StageSpec
from cosmos_curate_tpu_torch.core.tasks import PipelineTask
from cosmos_curate_tpu_torch.engine.dead_letter import list_entries


class Num(PipelineTask):
    def __init__(self, v: int) -> None:
        self.v = v


class Add(Stage):
    def __init__(self, delta=1, *, fail_values=(), sleep_s=0.0, cpus=0.5, bs=2) -> None:
        self.delta = delta
        self.fail_values = fail_values
        self.sleep_s = sleep_s
        self.cpus = cpus
        self.bs = bs
        self.threads: set[int] = set()
        self._lock = threading.Lock()

    @property
    def name(self) -> str:
        return f"add{self.delta}"

    @property
    def resources(self) -> Resources:
        return Resources(cpus=self.cpus)

    @property
    def batch_size(self) -> int:
        return self.bs

    def process_data(self, tasks):
        with self._lock:
            self.threads.add(threading.get_ident())
        if self.sleep_s:
            time.sleep(self.sleep_s)
        for t in tasks:
            if t.v in self.fail_values:
                raise RuntimeError(f"injected failure on {t.v}")
            t.v += self.delta
        return tasks


class SafeAdd(Add):
    """``Add`` declared thread-safe: the runner may fan it out."""

    @property
    def thread_safe(self) -> bool:
        return True


class Expand(Stage):
    """Dynamic chunking: one task in, two out."""

    @property
    def name(self) -> str:
        return "expand"

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.5)

    def process_data(self, tasks):
        return [Num(t.v) for t in tasks for _ in range(2)]


class _Model(ModelInterface):
    @property
    def model_id_names(self) -> list[str]:
        return []

    def setup(self) -> None:
        pass


class PinnedStage(Stage):
    """A GPU claim, a model stage or a plain CPU stage: the runner runs each
    on exactly one thread."""

    def __init__(self, *, gpu: bool, model: bool = True, thread_safe: bool = False) -> None:
        self.gpu = gpu
        self.threads: set[int] = set()
        self._lock = threading.Lock()
        self._model = _Model() if model and not gpu else None
        self._thread_safe = thread_safe

    @property
    def thread_safe(self) -> bool:
        return self._thread_safe

    @property
    def name(self) -> str:
        return "pinned"

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.5, gpus=1.0 if self.gpu else 0.0)

    @property
    def model(self):
        return self._model

    def process_data(self, tasks):
        with self._lock:
            self.threads.add(threading.get_ident())
        time.sleep(0.01)
        return tasks


class Lifecycle(Stage):
    """Records setup/destroy counts; optionally fails on a value."""

    def __init__(self, name: str, fail_values=()) -> None:
        self._name = name
        self.fail_values = fail_values
        self.setups = 0
        self.destroys = 0

    @property
    def name(self) -> str:
        return self._name

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.25)

    def setup(self, worker):
        self.setups += 1

    def process_data(self, tasks):
        for t in tasks:
            if t.v in self.fail_values:
                raise RuntimeError(f"boom on {t.v}")
        return tasks

    def destroy(self):
        self.destroys += 1


def test_end_to_end_matches_sequential():
    seq = run_pipeline([Num(i) for i in range(7)], [Add(1), Expand(), Add(10)], runner=SequentialRunner())
    pipe_runner = PipelinedRunner()
    piped = run_pipeline([Num(i) for i in range(7)], [Add(1), Expand(), Add(10)], runner=pipe_runner)
    assert sorted(t.v for t in piped) == sorted(t.v for t in seq)
    assert pipe_runner.stage_times["add1"] >= 0
    counts = pipe_runner.stage_counts
    assert counts["expand"]["completed"] == counts["expand"]["dispatched"]
    assert counts["add10"]["errored"] == 0
    assert pipe_runner.pipeline_wall_s > 0 and 0.0 <= pipe_runner.overlap_frac < 1.0


def test_smoke_two_stage_pipeline():
    out = run_pipeline([Num(i) for i in range(5)], [Add(1), Add(10)], runner=PipelinedRunner())
    assert sorted(t.v for t in out) == [11 + i for i in range(5)]


def test_empty_input_runs_lifecycle():
    stages = [Lifecycle("a"), Lifecycle("b")]
    out = run_pipeline([], stages, runner=PipelinedRunner(), skip_validation=True)
    assert out == []
    for st in stages:
        assert st.setups == 1  # exactly once per stage, even with no tasks
        assert st.destroys == 1


@pytest.mark.parametrize("runner_cls", [PipelinedRunner, SequentialRunner])
def test_retries_then_drop_with_dlq(tmp_path, monkeypatch, runner_cls):
    """Both runners retry a failing batch, then persist it to the
    dead-letter queue and go on (DLQ parity)."""
    monkeypatch.setenv("CURATE_DLQ_DIR", str(tmp_path / "dlq"))
    stage = StageSpec(Add(1, fail_values=(2,)), num_run_attempts=2)
    runner = runner_cls(raise_on_error=False)
    out = run_pipeline([Num(i) for i in range(4)], [stage], runner=runner)
    survivors = sorted(t.v for t in out)
    assert 3 not in survivors  # v=2 never incremented
    assert len(survivors) < 4
    if runner_cls is PipelinedRunner:
        assert runner.stage_counts["add1"]["errored"] == 1
        assert runner.stage_counts["add1"]["dead_lettered"] == 1
    else:
        assert runner.dead_lettered == 1
    (entry,) = list_entries(str(tmp_path / "dlq"))
    assert entry.meta["stage"] == "add1"
    assert entry.meta["attempts"] == 2
    assert entry.meta["reason"] == "num_run_attempts (2) exhausted"
    assert entry.meta["schema_version"] == 2
    assert "injected failure" in entry.meta["error_tail"]
    assert any(t.v == 2 for t in entry.load_tasks())


def test_raise_on_error_propagates():
    with pytest.raises(RuntimeError, match="injected failure"):
        run_pipeline([Num(2)], [StageSpec(Add(1, fail_values=(2,)))], runner=PipelinedRunner())


@pytest.mark.parametrize("runner_cls", [PipelinedRunner, SequentialRunner])
def test_non_list_return_always_raises(runner_cls):
    """Contract violations surface regardless of raise_on_error instead of
    burning retries into the DLQ."""

    class Bad(Stage):
        @property
        def resources(self):
            return Resources(cpus=0.25)

        def process_data(self, tasks):
            return "nope"

    with pytest.raises(TypeError, match="must return"):
        run_pipeline(
            [Num(1)], [StageSpec(Bad(), num_run_attempts=3)],
            runner=runner_cls(raise_on_error=False), skip_validation=True,
        )


def test_clean_destroy_on_midrun_failure():
    stages = [Lifecycle("a"), Lifecycle("b", fail_values=(1,)), Lifecycle("c")]
    with pytest.raises(RuntimeError, match="boom"):
        run_pipeline([Num(i) for i in range(4)], stages, runner=PipelinedRunner(), skip_validation=True)
    for st in stages:
        if st.setups:  # every stage that was set up is destroyed
            assert st.destroys == 1


def test_backpressure_bounded_queue():
    """A slow consumer blocks the producer at the queue bound."""
    lead = []
    lock = threading.Lock()
    produced = [0]
    consumed = [0]

    class Producer(Stage):
        @property
        def name(self):
            return "producer"

        @property
        def resources(self):
            return Resources(cpus=0.25)

        def process_data(self, tasks):
            with lock:
                produced[0] += len(tasks)
            return tasks

    class SlowConsumer(Stage):
        @property
        def name(self):
            return "consumer"

        def process_data(self, tasks):
            with lock:
                consumed[0] += len(tasks)
                lead.append(produced[0] - consumed[0])
            time.sleep(0.02)
            return tasks

    cap = 2
    out = run_pipeline(
        [Num(i) for i in range(24)],
        [Producer(), SlowConsumer()],
        runner=PipelinedRunner(queue_capacity=cap, batch_linger_s=0.0),
        skip_validation=True,
    )
    assert len(out) == 24
    # queue (cap) + the consumer's batch in hand + the producer's finished
    # batch blocked ahead of the queue
    assert max(lead) <= cap + 2, f"producer ran {max(lead)} tasks ahead"


@pytest.mark.parametrize(
    ("gpu", "model", "thread_safe"),
    [(True, False, False), (False, True, False), (False, False, False), (True, False, True), (False, True, True)],
    ids=["gpu_claim", "pinned_model", "cpu_stage", "thread_safe_gpu_claim", "thread_safe_pinned_model"],
)
def test_device_stage_pinned_to_one_thread(gpu, model, thread_safe):
    """A GPU claim, a model that pins dispatch, or no ``thread_safe``
    declaration: one worker thread, whatever the budget."""
    stage = PinnedStage(gpu=gpu, model=model, thread_safe=thread_safe)
    out = run_pipeline(
        [Num(i) for i in range(8)], [stage],
        # a declared card: the GPU claim is placed without probing a device
        config=PipelineConfig(num_gpus=1, num_cpus=16), runner=PipelinedRunner(), skip_validation=True,
    )
    assert len(out) == 8
    assert len(stage.threads) == 1


def test_thread_safe_stage_fans_out_across_threads():
    stage = SafeAdd(1, sleep_s=0.02, cpus=0.25, bs=1)
    runner = PipelinedRunner()
    out = run_pipeline([Num(i) for i in range(16)], [stage], config=PipelineConfig(num_cpus=4), runner=runner)
    assert sorted(t.v for t in out) == [i + 1 for i in range(16)]
    assert len(stage.threads) > 1, "thread-safe CPU stage did not fan out"
    # 4 CPUs at 0.25 a worker, capped at the runner's thread cap
    assert runner.plans[0] == [min(16, runner.thread_cap)]
    assert runner.stage_counts["add1"]["workers"] == runner.plans[0][0]


def test_budget_bounds_the_fan_out():
    """One CPU of budget: a 0.5-CPU stage gets two workers, never more."""
    stage = SafeAdd(1, sleep_s=0.01, cpus=0.5, bs=1)
    runner = PipelinedRunner()
    run_pipeline([Num(i) for i in range(12)], [stage], config=PipelineConfig(num_cpus=1), runner=runner)
    assert runner.plans == [[2]] and runner.stage_counts["add1"]["workers"] == 2
    assert 1 < len(stage.threads) <= 2
    fixed = SafeAdd(1, sleep_s=0.01, cpus=0.25, bs=1)
    runner = PipelinedRunner()
    run_pipeline([Num(i) for i in range(12)], [StageSpec(fixed, num_workers=1)], config=PipelineConfig(num_cpus=8),
                 runner=runner)
    assert runner.plans == [[1]] and len(fixed.threads) == 1


def test_scale_down_drains_surplus_workers():
    """A fast thread-safe consumer behind a slow single-worker producer: with
    no rate yet it gets many workers; once measured with an empty queue the
    planner drops it to its minimum, and the surplus threads exit after the
    batch in hand. Nothing is lost."""
    consumer = SafeAdd(10, sleep_s=0.001, cpus=0.25, bs=1)
    runner = PipelinedRunner(replan_interval_s=0.05, batch_linger_s=0.0)
    out = run_pipeline([Num(i) for i in range(30)], [Add(1, sleep_s=0.03, bs=1), consumer],
                       config=PipelineConfig(num_cpus=4), runner=runner, skip_validation=True)
    assert sorted(t.v for t in out) == [i + 11 for i in range(30)]
    assert runner.plans[0][1] > 1, runner.plans
    assert min(plan[1] for plan in runner.plans) == 1, runner.plans
    assert runner.stage_counts["add10"]["completed"] == 30


def test_setup_and_destroy_run_once_with_several_threads():
    class SafeLifecycle(Lifecycle):
        def __init__(self, name):
            super().__init__(name)
            self.threads: set[int] = set()

        @property
        def thread_safe(self):
            return True

        def setup(self, worker):
            time.sleep(0.1)  # the other threads wait for it
            super().setup(worker)

        def process_data(self, tasks):
            assert self.setups == 1, "process_data before setup"
            self.threads.add(threading.get_ident())
            time.sleep(0.01)
            return super().process_data(tasks)

    stages = [SafeLifecycle("a"), SafeLifecycle("b")]
    runner = PipelinedRunner()
    out = run_pipeline([Num(i) for i in range(20)], [StageSpec(st, num_workers=3) for st in stages],
                       config=PipelineConfig(num_cpus=4), runner=runner)
    assert len(out) == 20
    for st in stages:
        assert st.setups == 1 and st.destroys == 1
        assert len(st.threads) > 1
        assert runner.stage_counts[st.name]["workers"] == 3


@pytest.mark.parametrize("kind", ["crash", "hang"])
def test_chaos_fault_in_a_fanned_out_stage(kind):
    """``worker.batch.crash`` (an error-kind fault: one attempt lost, the
    retry recovers) and ``worker.batch.hang`` (one batch stuck for 0.5 s
    while the stage's other threads go on) in a stage with several worker
    threads: the full output set either way."""
    site, rule = {
        "crash": (chaos.SITE_WORKER_CRASH, dict(kind="error", count=1)),
        "hang": (chaos.SITE_WORKER_HANG, dict(kind="hang", count=1, delay_s=0.5)),
    }[kind]
    stage = SafeAdd(1, sleep_s=0.01, cpus=0.25, bs=1)
    done_at: list[float] = []
    real = stage.process_data

    def timed(tasks):
        out = real(tasks)
        done_at.append(time.monotonic())
        return out

    stage.process_data = timed
    chaos.install(chaos.FaultPlan(rules=(chaos.FaultRule(site=site, **rule),), seed=3))
    try:
        t0 = time.monotonic()
        out = run_pipeline([Num(i) for i in range(16)], [StageSpec(stage, num_run_attempts=2)],
                           config=PipelineConfig(num_cpus=2), runner=PipelinedRunner())
        assert chaos.fire_count(site) == 1
    finally:
        chaos.uninstall()
    assert sorted(t.v for t in out) == [i + 1 for i in range(16)]
    assert len(stage.threads) > 1
    if kind == "hang":
        # the other threads finished most batches while one batch hung
        assert sum(t - t0 < 0.5 for t in done_at) >= 12, done_at


def test_overlap_counts_stage_work_not_setup():
    """Two stages that overlap: the second processes task i while the first
    processes task i + 1. A slow setup is not stage work, so it does not
    hide the overlap."""

    class Slow(Add):
        def setup(self, worker):
            time.sleep(0.5)

    stages = [Slow(1, sleep_s=0.05, bs=1), Add(10, sleep_s=0.05, bs=1)]
    runner = PipelinedRunner(batch_linger_s=0.0)
    out = run_pipeline([Num(i) for i in range(8)], stages, runner=runner, skip_validation=True)
    assert sorted(t.v for t in out) == [i + 11 for i in range(8)]
    assert runner.pipeline_wall_s > 0.5 + 0.05 * 8
    assert runner.overlap_frac > 0.2, runner.overlap_frac
    alone = PipelinedRunner()
    run_pipeline([Num(i) for i in range(4)], [Add(1, sleep_s=0.02, bs=1)], runner=alone, skip_validation=True)
    assert alone.overlap_frac == 0.0


@pytest.mark.parametrize("runner_cls", [PipelinedRunner, SequentialRunner])
def test_chaos_crash_and_retry(runner_cls):
    """The worker.batch.crash site fires per batch attempt; an error-kind
    fault consumes one attempt and the retry gives the full output set."""
    chaos.install(chaos.FaultPlan(rules=(chaos.FaultRule(site=chaos.SITE_WORKER_CRASH, kind="error", count=1),), seed=7))
    try:
        out = run_pipeline([Num(i) for i in range(6)], [StageSpec(Add(1), num_run_attempts=2)], runner=runner_cls())
        assert chaos.fire_count(chaos.SITE_WORKER_CRASH) == 1
    finally:
        chaos.uninstall()
    assert sorted(t.v for t in out) == [i + 1 for i in range(6)]


def test_chaos_refuses_unknown_and_duplicate_sites():
    with pytest.raises(ValueError, match="unknown chaos site"):
        chaos.install(chaos.FaultPlan(rules=(chaos.FaultRule(site="storage.request"),)))
    rule = chaos.FaultRule(site=chaos.SITE_WORKER_HANG, kind="delay")
    with pytest.raises(ValueError, match="duplicate"):
        chaos.install(chaos.FaultPlan(rules=(rule, rule)))
    assert not chaos.enabled()


def test_default_runner_selection(monkeypatch):
    monkeypatch.delenv("CURATE_ENGINE_DRIVER_PORT", raising=False)
    for choice in ("", "auto", "pipelined"):
        monkeypatch.setenv("CURATE_RUNNER", choice)
        runner = default_runner()
        assert isinstance(runner, PipelinedRunner)
        # production semantics: an exhausted batch dead-letters and the run
        # continues
        assert runner.raise_on_error is False
    monkeypatch.setenv("CURATE_RUNNER", "sequential")
    assert isinstance(default_runner(), SequentialRunner)
    # the reference's multi-process runners are not ported: they raise and
    # name their ROADMAP item, never fall back to another runner
    for choice in ("engine", "streaming", "map"):
        monkeypatch.setenv("CURATE_RUNNER", choice)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            default_runner()
    monkeypatch.setenv("CURATE_RUNNER", "auto")
    monkeypatch.setenv("CURATE_ENGINE_DRIVER_PORT", "7070")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        default_runner()
    # a typo fails loudly, never silently lands on the threaded default
    monkeypatch.setenv("CURATE_RUNNER", "sequental")
    with pytest.raises(ValueError, match="unknown CURATE_RUNNER"):
        default_runner()


def test_gpu_stage_on_a_host_without_one_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline([Num(1)], [PinnedStage(gpu=True)], runner=PipelinedRunner(), skip_validation=True)


# ---------------------------------------------------------------------------
# across the two packages


def _toy_chain(stage_mod, task_mod, tag):
    """The same three-stage chain built on one package's base classes: add
    1, fan each task out to two, add 10 (CPU stages, batch 2; declared
    thread-safe, which lets both runners fan them out)."""

    class N(task_mod.PipelineTask):
        def __init__(self, v):
            self.v = v

    class AddN(stage_mod.Stage):
        def __init__(self, delta):
            self.delta = delta

        @property
        def name(self):
            return f"{tag}-add{self.delta}"

        @property
        def resources(self):
            return stage_mod.Resources(cpus=0.5)

        @property
        def thread_safe(self):
            return True

        @property
        def batch_size(self):
            return 2

        def process_data(self, tasks):
            for t in tasks:
                t.v += self.delta
            return tasks

    class Fan(stage_mod.Stage):
        @property
        def thread_safe(self):
            return True

        def process_data(self, tasks):
            return [N(t.v * 100 + k) for t in tasks for k in range(2)]

    return [N(i) for i in range(9)], [AddN(1), Fan(), AddN(10)]


@pytest.mark.parametrize("runner", ["sequential", "pipelined"])
def test_same_output_set_as_the_jax_runners(runner):
    jtasks_in, jstages = _toy_chain(jstage, jtasks, "j")
    ttasks_in, tstages = _toy_chain(tstage, ttasks, "t")
    jr = JSequentialRunner() if runner == "sequential" else JPipelinedRunner()
    tr = SequentialRunner() if runner == "sequential" else PipelinedRunner()
    jout = jrun_pipeline(jtasks_in, jstages, runner=jr)
    tout = run_pipeline(ttasks_in, tstages, runner=tr)
    assert len(tout) == 18
    assert sorted(t.v for t in tout) == sorted(t.v for t in jout)


class JA(jtasks.PipelineTask):
    pass


class JB(jtasks.PipelineTask):
    pass


class JEmitsA(jstage.Stage):
    def process_data(self, tasks: list[JA]) -> list[JA]:
        return tasks


class JTakesB(jstage.Stage):
    def process_data(self, tasks: list[JB]) -> list[JB]:
        return tasks


class TA(ttasks.PipelineTask):
    pass


class TB(ttasks.PipelineTask):
    pass


class TEmitsA(tstage.Stage):
    def process_data(self, tasks: list[TA]) -> list[TA]:
        return tasks


class TTakesB(tstage.Stage):
    def process_data(self, tasks: list[TB]) -> list[TB]:
        return tasks


def test_miswired_pipeline_raises_in_both_packages():
    """A stage that accepts only one task type after a stage that emits
    another: both pre-flights refuse the spec before any worker starts,
    with the same findings."""
    with pytest.raises(JValidationError, match="type-flow") as jerr:
        jrun_pipeline([JA()], [JEmitsA(), JTakesB()], runner=JSequentialRunner())
    with pytest.raises(PipelineValidationError, match="type-flow") as terr:
        run_pipeline([TA()], [TEmitsA(), TTakesB()], runner=SequentialRunner())
    rename = {"JA": "TA", "JB": "TB", "JEmitsA": "TEmitsA", "JTakesB": "TTakesB"}
    want = [f.message for f in jerr.value.findings]
    for j, t in rename.items():
        want = [m.replace(f"'{j}'", f"'{t}'").replace(f" {j}", f" {t}") for m in want]
    assert [f.rule for f in terr.value.findings] == [f.rule for f in jerr.value.findings]
    assert [f.message for f in terr.value.findings] == want


def test_resource_findings_match_the_jax_preflight():
    """A contradictory device request and no run attempt: the port's
    pre-flight reports the reference's rules, in GPU terms."""
    from cosmos_curate_tpu.core.pipeline import PipelineConfig as JConfig

    class JDev(jstage.Stage):
        @property
        def resources(self):
            return jstage.Resources(tpus=1.0, entire_tpu_host=True)

        def process_data(self, tasks):
            return tasks

    class TDev(tstage.Stage):
        @property
        def resources(self):
            return tstage.Resources(gpus=1.0, entire_gpu_host=True)

        def process_data(self, tasks):
            return tasks

    with pytest.raises(JValidationError) as jerr:
        jrun_pipeline([], [jstage.StageSpec(JDev(), num_run_attempts=0)],
                      config=JConfig(num_tpu_chips=1), runner=JSequentialRunner())
    with pytest.raises(PipelineValidationError) as terr:
        run_pipeline([], [tstage.StageSpec(TDev(), num_run_attempts=0)],
                     config=PipelineConfig(num_gpus=1), runner=SequentialRunner())
    assert sorted(f.rule for f in terr.value.findings) == sorted(f.rule for f in jerr.value.findings)
    assert "entire_gpu_host" in str(terr.value)


def test_chaos_sites_match_the_jax_harness():
    assert chaos.SITE_WORKER_CRASH == jchaos.SITE_WORKER_CRASH
    assert chaos.SITE_WORKER_HANG == jchaos.SITE_WORKER_HANG


class _Claim(tstage.Stage):
    def __init__(self, res: Resources) -> None:
        self.res = res

    @property
    def name(self):
        return f"claim-{self.res.gpus:g}-{self.res.entire_gpu_host}"

    @property
    def resources(self):
        return self.res

    def process_data(self, tasks):
        return tasks


@pytest.mark.parametrize(
    ("claims", "host", "bad"),
    [
        # the main path on one card: embed claims a card, caption the host;
        # the stages share the card, so the claims are not summed
        ((Resources(gpus=1.0), Resources(entire_gpu_host=True)), 1, []),
        ((Resources(gpus=2.0),), 1, ["claim-2-False"]),
        ((Resources(entire_gpu_host=True), Resources(cpus=4.0)), 0, ["claim-0-True"]),
    ],
    ids=["one_card_main_path", "claim_above_host", "host_claim_without_cards"],
)
def test_gpu_claims_checked_against_the_declared_host(claims, host, bad):
    from cosmos_curate_tpu_torch.analysis.graph_lint import lint_pipeline_spec
    from cosmos_curate_tpu_torch.core.pipeline import PipelineSpec

    spec = PipelineSpec([], [StageSpec(_Claim(r)) for r in claims], PipelineConfig(num_gpus=host))
    found = [f for f in lint_pipeline_spec(spec) if f.rule == "infeasible-stage"]
    assert [f.message.split("'")[1] for f in found] == bad
