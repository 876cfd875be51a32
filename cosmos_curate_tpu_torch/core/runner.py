"""Runner abstraction + the in-process SequentialRunner, and the runner
selection of ``run_pipeline`` (port of ``cosmos_curate_tpu/core/runner.py``).

Both runners open the reference's spans (``pipeline.run``, and per stage
``stage.<name>``, ``stage.<name>.setup`` and ``stage.<name>.process``) and
publish its live-status snapshots (observability/live_status.py) when
``CURATE_LIVE_STATUS_DIR`` is set, as ``run_split`` does on every run.

``default_runner`` selects the reference's runners: the pipelined runner
(core/pipelined_runner.py) by default, and ``CURATE_RUNNER`` names one of
``sequential``, ``pipelined``, ``engine`` / ``streaming`` (the streaming
engine, engine/runner.py) or ``map`` (core/map_runner.py); with
``CURATE_ENGINE_DRIVER_PORT`` set, the default is the streaming engine with
its cross-node plane (engine/remote_plane.py).
"""

from __future__ import annotations

import abc
import os
import time
import traceback

from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.core.pipeline import PipelineSpec
from cosmos_curate_tpu_torch.core.stage import NodeInfo, WorkerMetadata
from cosmos_curate_tpu_torch.core.tasks import PipelineTask
from cosmos_curate_tpu_torch.engine.dead_letter import DeadLetterQueue, record_exhausted_batch
from cosmos_curate_tpu_torch.observability.live_status import LiveStatusPublisher
from cosmos_curate_tpu_torch.observability.tracing import traced_span
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

RUNNER_ENV = "CURATE_RUNNER"
ENGINE_DRIVER_PORT_ENV = "CURATE_ENGINE_DRIVER_PORT"
RUNNER_CHOICES = ("auto", "sequential", "pipelined", "engine", "streaming", "map")


class RunnerInterface(abc.ABC):
    """Executes a ``PipelineSpec``; returns last-stage outputs (or None)."""

    @abc.abstractmethod
    def run(self, spec: PipelineSpec) -> list[PipelineTask] | None: ...


class SequentialRunner(RunnerInterface):
    """Run every stage in-process, stage by stage, no parallelism.

    Exact lifecycle per stage: ``setup_on_node`` -> ``setup`` ->
    ``process_data`` over batches -> ``destroy``. Honors ``batch_size`` and
    dynamic chunking (a stage may emit more or fewer tasks than it
    received). This is both the test harness and the minimal local runner.
    """

    def __init__(self, *, raise_on_error: bool = True) -> None:
        self.raise_on_error = raise_on_error
        # stage name -> wall seconds, summed over runs
        self.stage_times: dict[str, float] = {}
        # run-scoped dead-letter queue of dropped batches; lazy: a clean run
        # creates nothing
        self.dlq: DeadLetterQueue | None = None
        self.dead_lettered = 0
        self._publisher: LiveStatusPublisher | None = None
        self._live_stages: dict[str, dict] = {}

    def run(self, spec: PipelineSpec) -> list[PipelineTask] | None:
        # fresh run-scoped DLQ state (its run id is fixed at construction)
        self.dlq = None
        self.dead_lettered = 0
        node = NodeInfo(node_id="local")
        tasks: list[PipelineTask] = list(spec.input_data)
        # live status: snapshots publish between batches (one thread, so a
        # hung batch shows as a stale snapshot whose in-flight entry is it)
        self._publisher = LiveStatusPublisher.from_env(runner="sequential")
        self._live_stages = {
            s.stage.name: {"queue_depth": 0, "workers": 0, "completed": 0, "errored": 0, "dead_lettered": 0,
                           "busy_frac": 0.0, "inflight": []}
            for s in spec.stages
        }
        try:
            with traced_span("pipeline.run", runner="sequential", stages=len(spec.stages)):
                for stage_spec in spec.stages:
                    tasks = self._run_stage(stage_spec, node, tasks)
        finally:
            if self._publisher is not None:
                try:
                    self._publisher.finalize({"stages": dict(self._live_stages)})
                except Exception:
                    logger.exception("final live-status publish failed")
        return tasks if spec.config.return_last_stage_outputs else None

    def _run_stage(self, stage_spec, node: NodeInfo, tasks: list) -> list:
        stage = stage_spec.stage
        worker = f"{stage.name}-seq-0"
        meta = WorkerMetadata(worker_id=worker, stage_name=stage.name, node=node, allocation=stage.resources)
        t0 = time.monotonic()
        out: list[PipelineTask] = []
        with traced_span(f"stage.{stage.name}", stage=stage.name):
            with traced_span(f"stage.{stage.name}.setup"):
                stage.setup_on_node(node, meta)
                stage.setup(meta)
            bs = max(1, stage.batch_size)
            attempts = max(1, stage_spec.num_run_attempts)
            live = self._live_stages[stage.name] if self._publisher is not None else None
            try:
                for i in range(0, len(tasks), bs):
                    batch = tasks[i : i + bs]
                    # per-BATCH baseline: dead_lettered counts over the run
                    dl_before = self.dead_lettered
                    if live is not None:
                        live.update(queue_depth=max(0, len(tasks) - i - len(batch)), workers=1, busy_frac=1.0,
                                    inflight=[{"batch_id": i // bs, "age_s": 0.0, "attempt": 1, "worker": worker}])
                        self._publisher.maybe_publish(lambda: {"stages": dict(self._live_stages)})
                    for attempt in range(attempts):
                        try:
                            chaos.fire(chaos.SITE_WORKER_CRASH)  # kind=crash: os._exit
                            chaos.fire(chaos.SITE_WORKER_HANG)  # kind=hang: stuck batch
                            with traced_span(f"stage.{stage.name}.process", batch_size=len(batch)):
                                result = stage.process_data(batch)
                            break
                        except Exception:
                            if attempt + 1 >= attempts:
                                if self.raise_on_error:
                                    raise
                                logger.exception("stage %s failed on batch %d; dropping", stage.name, i)
                                self._dead_letter(stage.name, i, batch, attempt + 1)
                                result = None
                    if live is not None:
                        live["inflight"] = []
                        live["busy_frac"] = 0.0
                        # a dropped batch raised the DLQ count in
                        # _dead_letter; anything else completed (a None
                        # result is a success without output)
                        if self.dead_lettered > dl_before:
                            live["errored"] += 1
                            live["dead_lettered"] += self.dead_lettered - dl_before
                        else:
                            live["completed"] += 1
                    if result is None:
                        continue
                    if not isinstance(result, list):
                        raise TypeError(
                            f"stage {stage.name}.process_data must return "
                            f"list[PipelineTask] or None, got {type(result).__name__}"
                        )
                    out.extend(result)
            finally:
                stage.destroy()
        stage_s = time.monotonic() - t0
        self.stage_times[stage.name] = self.stage_times.get(stage.name, 0.0) + stage_s
        logger.info("stage %s: %d -> %d tasks in %.2fs", stage.name, len(tasks), len(out), stage_s)
        return out

    def _dead_letter(self, stage_name: str, batch_id: int, tasks: list, attempts: int) -> None:
        """Persist a dropped batch to the durable DLQ. Never raises: a DLQ
        failure degrades to the log-only drop above."""
        if self.dlq is None:
            self.dlq = DeadLetterQueue()
        if record_exhausted_batch(
            self.dlq,
            stage_name=stage_name,
            batch_id=batch_id,
            tasks=tasks,
            attempts=attempts,
            error=traceback.format_exc(),
        ):
            self.dead_lettered += 1


def default_runner() -> RunnerInterface:
    """Production runner selection.

    ``CURATE_RUNNER=sequential|pipelined|engine|streaming|map`` forces a
    backend; unset or ``auto`` picks the ``PipelinedRunner``
    (stage-overlapped thread pools on this host). ``auto`` with a remote
    data plane configured (``CURATE_ENGINE_DRIVER_PORT``) selects the
    streaming engine, as in the reference, whose run then serves the
    cross-node plane (engine/remote_plane.py).
    """
    choice = os.environ.get(RUNNER_ENV, "").strip().lower()
    known = ("", *RUNNER_CHOICES)
    if choice not in known:
        # a typo must not silently land on the multi-threaded default
        raise ValueError(f"unknown {RUNNER_ENV}={choice!r}; expected one of {known[1:]}")
    if choice == "sequential":
        return SequentialRunner()
    if choice == "map":
        from cosmos_curate_tpu_torch.core.map_runner import MapRunner

        return MapRunner()
    if choice in ("engine", "streaming") or (choice in ("", "auto") and os.environ.get(ENGINE_DRIVER_PORT_ENV)):
        from cosmos_curate_tpu_torch.engine.runner import StreamingRunner

        return StreamingRunner()
    from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner

    # production semantics: an exhausted batch is dead-lettered and the run
    # continues. Tests wanting fail-fast construct the runner directly
    # (raise_on_error defaults to True there, as in SequentialRunner).
    return PipelinedRunner(raise_on_error=False)
