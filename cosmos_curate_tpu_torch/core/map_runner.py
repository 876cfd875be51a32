"""MapRunner: stage-by-stage execution over a process pool (port of
``cosmos_curate_tpu/core/map_runner.py``).

The reference's second backend beside the streaming engine: each stage
runs to completion over all tasks before the next starts (a barrier), CPU
stages fanned out over a ``ProcessPoolExecutor`` of spawned processes, and
GPU stages (and stages pinned to one worker) run in this process through a
``SequentialRunner``, since the cards belong to one process.

- Lifecycle per stage: each pool process runs ``setup_on_node`` ->
  ``setup`` once (the pool initializer), then ``process_data`` per batch;
  ``destroy`` runs at the process's exit.
- A batch is re-run up to ``StageSpec.num_run_attempts`` times; a batch
  that still fails is dropped (``raise_on_error=False``) or aborts the run.
- ``stage_times`` as the other runners keep it.

A pool process runs with ``CUDA_VISIBLE_DEVICES=""``, set before the stage
is unpickled: a CPU stage never creates a CUDA context. Stages and batches
travel by cloudpickle where the reference uses pickle, so the observability
wrappers' run-time subclasses (observability/profiling.py, stage_replay.py)
and classes of a driver script travel by value.
"""

from __future__ import annotations

import atexit
import multiprocessing
import os
import time
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait

from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig, PipelineSpec
from cosmos_curate_tpu_torch.core.runner import RunnerInterface, SequentialRunner
from cosmos_curate_tpu_torch.core.stage import NodeInfo, WorkerMetadata
from cosmos_curate_tpu_torch.core.tasks import PipelineTask
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_WORKER_STAGE = None


def _worker_init(stage_bytes: bytes, stage_name: str) -> None:
    global _WORKER_STAGE
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # a CPU stage's process never claims a card
    import cloudpickle

    stage = cloudpickle.loads(stage_bytes)
    node = NodeInfo(node_id="local")
    meta = WorkerMetadata(worker_id=f"{stage_name}-map-{os.getpid()}", stage_name=stage_name, node=node,
                          allocation=stage.resources)
    stage.setup_on_node(node, meta)
    stage.setup(meta)
    _WORKER_STAGE = stage
    atexit.register(stage.destroy)


def _worker_process(batch_bytes: bytes) -> bytes:
    import cloudpickle

    batch = cloudpickle.loads(batch_bytes)
    result = _WORKER_STAGE.process_data(batch)
    if result is not None and not isinstance(result, list):
        raise TypeError(f"stage {_WORKER_STAGE.name}.process_data must return "
                        f"list[PipelineTask] or None, got {type(result).__name__}")
    return cloudpickle.dumps(result)


class MapRunner(RunnerInterface):
    """Barrier-per-stage map execution over a process pool."""

    def __init__(self, *, max_workers: int | None = None, raise_on_error: bool = True) -> None:
        self.max_workers = max_workers
        self.raise_on_error = raise_on_error
        self.stage_times: dict[str, float] = {}

    def _stage_workers(self, stage_spec) -> int:
        cap = self.max_workers if self.max_workers is not None else max(1, os.cpu_count() or 1)
        wanted = stage_spec.num_workers or cap
        return max(1, min(wanted, cap))

    def run(self, spec: PipelineSpec) -> list[PipelineTask] | None:
        tasks: list[PipelineTask] = list(spec.input_data)
        for stage_spec in spec.stages:
            stage = stage_spec.stage
            t0 = time.monotonic()
            workers = self._stage_workers(stage_spec)
            # the cards belong to this process: GPU stages (and explicit
            # one-worker stages) run inline
            inline = stage.resources.uses_gpu or workers == 1
            if inline:
                tasks = self._run_inline(stage_spec, tasks)
            else:
                tasks = self._run_pool(stage, stage_spec, tasks, workers)
            stage_s = time.monotonic() - t0
            self.stage_times[stage.name] = self.stage_times.get(stage.name, 0.0) + stage_s
            logger.info("map stage %s: -> %d tasks in %.2fs (%s)", stage.name, len(tasks), stage_s,
                        "inline" if inline else f"{workers} procs")
        return tasks if spec.config.return_last_stage_outputs else None

    def _run_inline(self, stage_spec, tasks):
        sub = SequentialRunner(raise_on_error=self.raise_on_error)
        return sub.run(PipelineSpec(input_data=tasks, stages=[stage_spec],
                                    config=PipelineConfig(return_last_stage_outputs=True))) or []

    def _run_pool(self, stage, stage_spec, tasks, workers):
        import cloudpickle

        bs = max(1, stage.batch_size)
        batches = [tasks[i : i + bs] for i in range(0, len(tasks), bs)]
        if not batches:
            return []
        out: list[PipelineTask] = []
        attempts = max(1, stage_spec.num_run_attempts)
        with ProcessPoolExecutor(max_workers=min(workers, len(batches)), mp_context=multiprocessing.get_context("spawn"),
                                 initializer=_worker_init, initargs=(cloudpickle.dumps(stage), stage.name)) as pool:
            pending = {pool.submit(_worker_process, cloudpickle.dumps(b)): (b, 1) for b in batches}
            while pending:
                done, _ = wait(pending, return_when=FIRST_COMPLETED)
                for fut in done:
                    batch, attempt = pending.pop(fut)
                    try:
                        result = cloudpickle.loads(fut.result())
                    except Exception:
                        if attempt < attempts:
                            pending[pool.submit(_worker_process, cloudpickle.dumps(batch))] = (batch, attempt + 1)
                            continue
                        if self.raise_on_error:
                            raise
                        logger.exception("map stage %s: batch failed after %d attempts; dropping", stage.name,
                                         attempt)
                        continue
                    if result:
                        out.extend(result)
        return out
