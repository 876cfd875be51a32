"""PipelinedRunner: stage-overlapped execution on one host (port of
``cosmos_curate_tpu/core/pipelined_runner.py``).

Every stage runs in its own worker thread, connected to the next by a
bounded queue with backpressure, so the CPU stages of task N + 1 overlap
the device stages of task N, and two device stages (the embedder and the
caption engine) keep one card busy from two threads.

Semantics shared with ``SequentialRunner`` (tests/test_torch_pipeline.py
holds the output sets equal):

- lifecycle per stage: ``setup_on_node`` -> ``setup`` exactly once per
  stage, ``process_data`` per batch, ``destroy`` exactly once when the
  stage drains or the run aborts;
- ``StageSpec.num_run_attempts`` retries a failing batch in place; an
  exhausted batch aborts the run (``raise_on_error=True``) or is dropped
  through the durable dead-letter queue (engine/dead_letter.py);
- dynamic chunking: a stage may emit more or fewer tasks than it received;
- chaos sites ``worker.batch.crash`` / ``worker.batch.hang`` fire per batch
  attempt (chaos/harness.py).

Every stage gets exactly ONE worker thread, so the state of a device
stage's ``DevicePipeline`` (its in-flight window and side streams) stays
single-threaded. A stage that claims a GPU gets every card of the host in
``WorkerMetadata.gpu_ids``; the stages share the cards. The reference's
fan-out of thread-safe CPU stages and its worker-count planner are not
ported: every stage of the port's path is a device stage or single-threaded
prep (ROADMAP queue A item 9).

Device work crosses stages only as host arrays: every device stage reads
its results back (numpy embeddings, caption text) before it returns its
batch. Each worker thread launches on its current CUDA stream, the default
one unless a stage chooses another.

Not ported: the reference's tracing spans, stage-flow gauges and
live-status snapshots, which wait for the observability layer (ROADMAP).
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque

from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.core.pipeline import PipelineSpec
from cosmos_curate_tpu_torch.core.runner import RunnerInterface
from cosmos_curate_tpu_torch.core.stage import NodeInfo, StageSpec, WorkerMetadata
from cosmos_curate_tpu_torch.core.tasks import PipelineTask
from cosmos_curate_tpu_torch.engine.dead_letter import DeadLetterQueue, record_exhausted_batch
from cosmos_curate_tpu_torch.engine.metrics import get_metrics
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class _TaskQueue:
    """Bounded task queue between adjacent stages.

    ``put_many`` blocks while the queue is at capacity (backpressure on the
    producer); ``get_batch`` assembles up to ``max_size`` tasks, lingering
    briefly for a fuller batch while the producer is still alive (fuller
    batches keep device batches full). ``close()`` marks the producer done:
    once closed AND empty, ``get_batch`` returns None and the stage's
    worker exits.
    """

    def __init__(self, capacity: int) -> None:
        self.capacity = max(1, capacity)
        self._buf: deque = deque()
        self._cond = threading.Condition()
        self._closed = False

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def drained(self) -> bool:
        """Producer done and nothing left to hand out."""
        with self._cond:
            return self._closed and not self._buf

    def put_many(self, tasks: list, should_stop) -> None:
        for t in tasks:
            with self._cond:
                while len(self._buf) >= self.capacity:
                    if should_stop():
                        return
                    self._cond.wait(0.05)
                self._buf.append(t)
                self._cond.notify_all()

    def get_batch(self, max_size: int, should_stop, linger_s: float) -> list | None:
        with self._cond:
            while True:
                if should_stop():
                    return None
                if self._buf:
                    break
                if self._closed:
                    return None
                self._cond.wait(0.05)
            batch = [self._buf.popleft()]
            deadline = time.monotonic() + linger_s
            while len(batch) < max_size:
                if self._buf:
                    batch.append(self._buf.popleft())
                    continue
                if self._closed or should_stop():
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, 0.05))
            self._cond.notify_all()  # wake producers blocked on capacity
            return batch


class _StageRuntime:
    """One stage's queue, worker thread, and bookkeeping."""

    def __init__(self, idx: int, spec: StageSpec, in_q: _TaskQueue, emit) -> None:
        self.idx = idx
        self.spec = spec
        self.stage = spec.stage
        self.in_q = in_q
        self.emit = emit  # callable(list[PipelineTask]) -> None
        self.thread: threading.Thread | None = None
        self.lock = threading.Lock()
        self.setup_ok = False
        self.destroyed = False
        self.finalized = False
        self.next_batch_id = 0
        # accounting (guarded by self.lock)
        self.busy_s = 0.0
        self.first_start: float | None = None  # monotonic start of the first batch
        self.last_end: float | None = None  # monotonic end of the last batch
        self.dispatched = 0
        self.completed = 0
        self.errored = 0
        self.dead_lettered = 0

    @property
    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()


_ABORTED = object()  # worker-loop sentinel: run is aborting, exit now
_POLL_S = 0.02  # how often the driver loop looks for drained stages


class PipelinedRunner(RunnerInterface):
    """Run all stages concurrently, one worker thread each, on this host."""

    def __init__(
        self,
        *,
        raise_on_error: bool = True,
        queue_capacity: int = 16,
        batch_linger_s: float = 0.2,
    ) -> None:
        self.raise_on_error = raise_on_error
        self.queue_capacity = queue_capacity  # tasks waiting between two stages
        self.batch_linger_s = batch_linger_s
        self.metrics = get_metrics()
        # stage name -> summed process_data seconds (over runs)
        self.stage_times: dict[str, float] = {}
        self.stage_counts: dict[str, dict] = {}
        self.pipeline_wall_s = 0.0
        # the LAST run only: stage_times accumulates across runs, which
        # would fabricate overlap
        self._last_run_busy_s = 0.0
        self._last_run_active_s = 0.0
        self.dlq: DeadLetterQueue | None = None
        self._abort = threading.Event()
        self._stop = threading.Event()
        self._abort_lock = threading.Lock()
        self._abort_exc: BaseException | None = None

    @property
    def overlap_frac(self) -> float:
        """Fraction of total stage work hidden behind other stages over the
        LAST ``run()``: ``1 - active / sum(stage busy seconds)``, clamped at
        0, where ``active`` runs from the first batch's start to the last
        batch's end. Setup and teardown are not stage work, so they are left
        out of both sides."""
        busy = self._last_run_busy_s
        if busy <= 0 or self._last_run_active_s <= 0:
            return 0.0
        return max(0.0, 1.0 - self._last_run_active_s / busy)

    def run(self, spec: PipelineSpec) -> list[PipelineTask] | None:
        if not spec.stages:
            return list(spec.input_data) if spec.config.return_last_stage_outputs else None
        t_start = time.monotonic()
        self._abort.clear()
        self._stop.clear()
        self._abort_exc = None
        self.dlq = DeadLetterQueue()  # lazy: writes nothing unless a drop happens
        cfg = spec.config
        self._node = NodeInfo(node_id="local", num_gpus=discover_gpus(cfg, spec.stages))

        outputs: list[PipelineTask] = []
        outputs_lock = threading.Lock()

        def collect(tasks: list) -> None:
            if not cfg.return_last_stage_outputs:
                return
            with outputs_lock:
                outputs.extend(tasks)

        # stage i's input queue; queue 0 holds every input and is closed at
        # once (inputs are already in memory: backpressure matters BETWEEN
        # stages, where new payloads get created)
        queues = [_TaskQueue(self.queue_capacity) for _ in spec.stages]
        queues[0] = _TaskQueue(max(self.queue_capacity, len(spec.input_data)))
        runtimes: list[_StageRuntime] = []
        for i, stage_spec in enumerate(spec.stages):
            if i + 1 < len(spec.stages):
                nxt = queues[i + 1]
                emit = lambda tasks, q=nxt: q.put_many(tasks, self._should_stop)  # noqa: E731
            else:
                emit = collect
            runtimes.append(_StageRuntime(i, stage_spec, queues[i], emit))
        queues[0].put_many(list(spec.input_data), self._should_stop)
        queues[0].close()
        # every stage starts at once, an empty one too, so the setup ->
        # destroy lifecycle runs for every stage, as in SequentialRunner
        for rt in runtimes:
            self._start_worker(rt)

        try:
            while not self._abort.is_set():
                for rt in runtimes:
                    if rt.finalized or rt.alive or not rt.in_q.drained:
                        continue
                    self._finalize_stage(rt)
                    if rt.idx + 1 < len(queues):
                        queues[rt.idx + 1].close()
                if runtimes[-1].finalized:
                    break
                time.sleep(_POLL_S)
        finally:
            # ANY exit path (normal, abort, or a foreign exception such as
            # KeyboardInterrupt in the loop above) must unblock every worker,
            # or the joins below stall 30 s per thread. close() is
            # idempotent; the stop flag covers workers mid-linger.
            for q in queues:
                q.close()
            self._stop.set()
            for rt in runtimes:
                if rt.thread is not None:
                    rt.thread.join(timeout=30.0)
            for rt in runtimes:
                if rt.finalized:
                    continue
                if rt.alive:
                    # a wedged worker outlived the join grace: leaking its
                    # state beats racing destroy() against a live
                    # process_data on the same stage instance
                    logger.error("stage %s: worker still running after abort grace; skipping destroy()", rt.stage.name)
                    rt.finalized = True
                    continue
                self._finalize_stage(rt)
            self.pipeline_wall_s = time.monotonic() - t_start
            self._record_run_stats(runtimes)

        if self._abort_exc is not None:
            raise self._abort_exc
        return outputs if cfg.return_last_stage_outputs else None

    def _should_stop(self) -> bool:
        return self._abort.is_set() or self._stop.is_set()

    # -- worker side ---------------------------------------------------------
    def _worker_loop(self, rt: _StageRuntime, meta: WorkerMetadata) -> None:
        try:
            rt.stage.setup_on_node(self._node, meta)
            rt.stage.setup(meta)
            rt.setup_ok = True
        except Exception as e:
            self._trigger_abort(e)
            return
        bs = max(1, rt.stage.batch_size)
        attempts = max(1, rt.spec.num_run_attempts)
        while True:
            batch = rt.in_q.get_batch(bs, self._should_stop, self.batch_linger_s)
            if batch is None:
                return
            with rt.lock:
                rt.dispatched += 1
                batch_id = rt.next_batch_id
                rt.next_batch_id += 1
            result = self._run_batch(rt, batch, batch_id, attempts)
            if result is _ABORTED:
                return
            if result:
                rt.emit(result)

    def _run_batch(self, rt: _StageRuntime, batch: list, batch_id: int, attempts: int):
        stage = rt.stage
        for attempt in range(attempts):
            t0 = time.monotonic()
            try:
                chaos.fire(chaos.SITE_WORKER_CRASH)  # kind=crash: os._exit
                chaos.fire(chaos.SITE_WORKER_HANG)  # kind=hang: stuck batch
                result = stage.process_data(batch)
                if result is not None and not isinstance(result, list):
                    # contract violation, not a batch failure: it surfaces
                    # whatever raise_on_error says, never burns retries or
                    # lands in the dead-letter queue
                    self._trigger_abort(
                        TypeError(
                            f"stage {stage.name}.process_data must return "
                            f"list[PipelineTask] or None, got {type(result).__name__}"
                        )
                    )
                    return _ABORTED
                self._account(rt, t0, completed=True)
                self.metrics.observe_result(stage.name, time.monotonic() - t0, len(result or []))
                return result or []
            except Exception as e:
                self._account(rt, t0, completed=False)
                self.metrics.observe_error(stage.name)
                if attempt + 1 < attempts:
                    logger.warning(
                        "stage %s batch %d failed (attempt %d/%d), retrying: %s",
                        stage.name, batch_id, attempt + 1, attempts, e,
                    )
                    continue
                if self.raise_on_error:
                    self._trigger_abort(e)
                    return _ABORTED
                with rt.lock:
                    rt.errored += 1
                logger.exception(
                    "stage %s batch %d failed permanently; dropping %d tasks", stage.name, batch_id, len(batch)
                )
                self._dead_letter(rt, batch_id, batch, attempts)
                return []
        return []  # unreachable; attempts >= 1

    @staticmethod
    def _account(rt: _StageRuntime, t0: float, *, completed: bool) -> None:
        t1 = time.monotonic()
        with rt.lock:
            rt.busy_s += t1 - t0
            rt.first_start = t0 if rt.first_start is None else rt.first_start
            rt.last_end = t1
            rt.completed += completed

    def _trigger_abort(self, exc: BaseException) -> None:
        with self._abort_lock:
            if self._abort_exc is None:  # first failure wins
                self._abort_exc = exc
        self._abort.set()

    def _dead_letter(self, rt: _StageRuntime, batch_id: int, tasks: list, attempts: int) -> None:
        """Persist a permanently dropped batch. Never raises: a DLQ failure
        degrades to the log-only drop."""
        if record_exhausted_batch(
            self.dlq,
            stage_name=rt.stage.name,
            batch_id=batch_id,
            tasks=tasks,
            attempts=attempts,
            error=traceback.format_exc(),
        ):
            with rt.lock:
                rt.dead_lettered += 1

    def _start_worker(self, rt: _StageRuntime) -> None:
        meta = WorkerMetadata(
            worker_id=f"{rt.stage.name}-pipe-0",
            stage_name=rt.stage.name,
            node=self._node,
            allocation=rt.stage.resources,
            gpu_ids=tuple(range(self._node.num_gpus)) if rt.stage.resources.uses_gpu else (),
        )
        rt.thread = threading.Thread(target=self._worker_loop, args=(rt, meta), daemon=True, name=meta.worker_id)
        rt.thread.start()

    def _finalize_stage(self, rt: _StageRuntime) -> None:
        if rt.setup_ok and not rt.destroyed:
            rt.destroyed = True
            try:
                rt.stage.destroy()
            except Exception:
                logger.exception("stage %s destroy failed", rt.stage.name)
        rt.finalized = True

    def _record_run_stats(self, runtimes: list[_StageRuntime]) -> None:
        self.stage_counts = {}
        self._last_run_busy_s = 0.0
        starts, ends = [], []
        for rt in runtimes:
            with rt.lock:
                self._last_run_busy_s += rt.busy_s
                if rt.first_start is not None:
                    starts.append(rt.first_start)
                    ends.append(rt.last_end)
                self.stage_times[rt.stage.name] = self.stage_times.get(rt.stage.name, 0.0) + rt.busy_s
                counts = {
                    "dispatched": rt.dispatched,
                    "completed": rt.completed,
                    "errored": rt.errored,
                    "dead_lettered": rt.dead_lettered,
                }
                self.stage_counts[rt.stage.name] = counts
            logger.info(
                "stage %s: %d dispatched, %d completed, %d errored, %d dead-lettered (%.2fs busy)",
                rt.stage.name, counts["dispatched"], counts["completed"], counts["errored"],
                counts["dead_lettered"], rt.busy_s,
            )
        self._last_run_active_s = max(ends) - min(starts) if starts else 0.0
        self.metrics.set_overlap_frac(self.overlap_frac)
        if self.dlq is not None and self.dlq.recorded:
            logger.error("%d dropped batch(es) persisted to the dead-letter queue: %s", self.dlq.recorded, self.dlq.run_dir)


def discover_gpus(cfg, stage_specs: list[StageSpec]) -> int:
    """The host's CUDA device count. Probes the devices only when some
    stage claims a GPU; an explicit ``PipelineConfig.num_gpus`` wins
    outright. A stage that claims a GPU on a host with none raises: the
    pipeline cannot run as declared."""
    if cfg.num_gpus is not None:
        return cfg.num_gpus
    wanting = [s.name for s in stage_specs if s.stage.resources.uses_gpu]
    if not wanting:
        return 0
    import torch

    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(
            f"stage(s) {wanting} request a GPU and this host has no CUDA device; "
            "build them with device='cpu' to run on the CPU"
        )
    return count
