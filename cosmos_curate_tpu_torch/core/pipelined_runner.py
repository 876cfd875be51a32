"""PipelinedRunner: stage-overlapped execution on one host (port of
``cosmos_curate_tpu/core/pipelined_runner.py``).

Every stage runs in its own pool of worker threads, connected to the next by
a bounded queue with backpressure, so the CPU stages of task N + 1 overlap
the device stages of task N, and two device stages (the embedder and the
caption engine) keep one card busy from two threads.

Semantics shared with ``SequentialRunner`` (tests/test_torch_pipeline.py
holds the output sets equal):

- lifecycle per stage: ``setup_on_node`` -> ``setup`` exactly once per
  stage (its worker threads share the instance), ``process_data`` per
  batch, ``destroy`` exactly once when the stage drains or the run aborts;
- ``StageSpec.num_run_attempts`` retries a failing batch in place; an
  exhausted batch aborts the run (``raise_on_error=True``) or is dropped
  through the durable dead-letter queue (engine/dead_letter.py);
- dynamic chunking: a stage may emit more or fewer tasks than it received;
- chaos sites ``worker.batch.crash`` / ``worker.batch.hang`` fire per batch
  attempt (chaos/harness.py).

Placement rules:

- **device stages** (a stage that claims a GPU, or whose model pins
  dispatch: ``ModelInterface.pin_to_single_worker``) get exactly ONE worker
  thread, so a ``DevicePipeline``'s in-flight window and side streams stay
  single-threaded. A stage that claims a GPU gets every card of the host in
  ``WorkerMetadata.gpu_ids``; the stages share the cards;
- **CPU stages fan out** only when they declare ``thread_safe = True``
  (concurrent ``process_data`` on disjoint batches is safe); every other
  stage gets one thread. Pool sizes come from the water-filling planner
  (engine/autoscaler.py) over ``PipelineConfig.num_cpus`` (default: the
  host's cores) and the host's cards, each thread-safe stage capped at
  ``thread_cap`` threads, re-planned every ``replan_interval_s`` on each
  stage's per-worker rate over the last minute. A shrinking pool drains:
  the surplus threads finish the batch in hand and exit. The threads of a
  stage share its instance: the first thread in runs ``setup_on_node`` and
  ``setup`` while the others wait for it, and ``destroy`` runs once, after
  the last thread has exited.

Device work crosses stages only as host arrays: every device stage reads
its results back (numpy embeddings, caption text) before it returns its
batch, so a ``stage.<name>.process`` span covers the stage's device work
without the runner synchronising anything. Each worker thread launches on
its current CUDA stream, the default one unless a stage chooses another.

Observability, as in the reference: the run opens a ``pipeline.run`` span,
and each worker thread starts under ``contextvars.copy_context()``, so its
``stage.<name>.setup`` and ``stage.<name>.process`` spans parent onto the
run's span across the thread hop. Every completed batch folds its busy
seconds into stage_timer's stage flow; every replan tick exports the queue
depth and busy fraction. The driver loop, never a worker, publishes the
live-status snapshot (observability/live_status.py) from the counters and
the registry of in-flight batches kept here, when ``CURATE_LIVE_STATUS_DIR``
is set.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field, replace

from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.core.pipeline import PipelineConfig, PipelineSpec
from cosmos_curate_tpu_torch.core.runner import RunnerInterface
from cosmos_curate_tpu_torch.core.stage import NodeInfo, Stage, StageSpec, WorkerMetadata
from cosmos_curate_tpu_torch.core.tasks import PipelineTask
from cosmos_curate_tpu_torch.engine.autoscaler import Budget, StageScaleState, plan_allocation
from cosmos_curate_tpu_torch.engine.dead_letter import DeadLetterQueue, record_exhausted_batch
from cosmos_curate_tpu_torch.engine.metrics import get_metrics
from cosmos_curate_tpu_torch.observability.live_status import MAX_INFLIGHT_PER_STAGE, LiveStatusPublisher
from cosmos_curate_tpu_torch.observability.stage_timer import record_stage_busy, record_stage_flow
from cosmos_curate_tpu_torch.observability.tracing import traced_span
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class _TaskQueue:
    """Bounded task queue between adjacent stages.

    ``put_many`` blocks while the queue is at capacity (backpressure on the
    producer); ``get_batch`` assembles up to ``max_size`` tasks, lingering
    briefly for a fuller batch while the producer is still alive (fuller
    batches keep device batches full). ``close()`` marks the producer done:
    once closed AND empty, ``get_batch`` returns None and the stage's
    workers exit.
    """

    def __init__(self, capacity: int) -> None:
        self.capacity = max(1, capacity)
        self._buf: deque = deque()
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._buf)

    def set_capacity(self, capacity: int) -> None:
        with self._cond:
            self.capacity = max(1, capacity)
            self._cond.notify_all()

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


@dataclass
class _Worker:
    meta: WorkerMetadata
    stop: threading.Event = field(default_factory=threading.Event)
    thread: threading.Thread | None = None

    @property
    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()


class _StageRuntime:
    """One stage's queue, thread pool, and shared bookkeeping."""

    def __init__(self, idx: int, spec: StageSpec, in_q: _TaskQueue, emit) -> None:
        self.idx = idx
        self.spec = spec
        self.stage = spec.stage
        self.in_q = in_q
        self.emit = emit  # callable(list[PipelineTask]) -> None
        self.workers: list[_Worker] = []
        self.lock = threading.Lock()
        # setup / destroy run exactly once per stage: the first worker
        # thread in claims setup, the rest wait on the event
        self.setup_state = "pending"  # pending | running | ok | failed
        self.setup_done = threading.Event()
        self.destroyed = False
        self.finalized = False
        self.next_worker_idx = 0
        self.next_batch_id = 0
        # in-flight batches for the live status: batch_id -> {started,
        # worker, attempt} (guarded by self.lock). A hung process_data stays
        # here the whole time it hangs: the stuck_batch signal
        self.inflight: dict[int, dict] = {}
        # accounting (guarded by self.lock)
        self.busy_s = 0.0
        self.samples: deque = deque(maxlen=256)  # (t_end, batch seconds)
        self.first_start: float | None = None  # monotonic start of the first batch
        self.last_end: float | None = None  # monotonic end of the last batch
        self.dispatched = 0
        self.completed = 0
        self.errored = 0
        self.dead_lettered = 0
        # busy-fraction window of the replan tick (driver loop only)
        self.tick_busy_s = 0.0
        self.tick_t = time.monotonic()

    def busy_frac(self, now: float, busy: float, workers: int) -> float:
        """Worker busy fraction since the last replan tick."""
        dt = now - self.tick_t
        return min(1.0, (busy - self.tick_busy_s) / (dt * max(1, workers))) if dt > 0 else 0.0

    @property
    def alive(self) -> bool:
        """Some worker thread of the stage is still running."""
        return any(w.alive for w in self.workers)

    def live_workers(self) -> list[_Worker]:
        """Running workers not asked to stop."""
        return [w for w in self.workers if w.alive and not w.stop.is_set()]

    def throughput_per_worker(self, window_s: float) -> float | None:
        """Batches/s one worker achieves: the inverse mean batch duration
        over the recent window."""
        now = time.monotonic()
        with self.lock:
            recent = [dur for (t, dur) in self.samples if t >= now - window_s]
        if not recent:
            return None
        mean_t = sum(recent) / len(recent)
        return 1.0 / mean_t if mean_t > 0 else None


_ABORTED = object()  # worker-loop sentinel: run is aborting, exit now
_POLL_S = 0.02  # how often the driver loop looks for drained stages
_RATE_WINDOW_S = 60.0  # per-worker rate window of the planner's samples


class PipelinedRunner(RunnerInterface):
    """Run all stages concurrently in thread pools on this host."""

    def __init__(
        self,
        *,
        raise_on_error: bool = True,
        replan_interval_s: float = 2.0,
        queue_capacity: int | None = None,
        batch_linger_s: float = 0.2,
        thread_cap: int | None = None,
    ) -> None:
        self.raise_on_error = raise_on_error
        self.replan_interval_s = replan_interval_s
        # tasks waiting between two stages; None = the config's formula
        # (PipelineConfig.max_queued_*) over the stage's worker count
        self.queue_capacity = queue_capacity
        self.batch_linger_s = batch_linger_s
        # most threads one thread-safe stage may get
        self.thread_cap = thread_cap or max(4, (os.cpu_count() or 1) * 2)
        self.metrics = get_metrics()
        # stage name -> summed process_data seconds (over runs)
        self.stage_times: dict[str, float] = {}
        self.stage_counts: dict[str, dict] = {}
        # the LAST run's plans, in stage order: the first and each replan
        # that changed a target
        self.plans: list[list[int]] = []
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
        out of both sides. Worker threads of one stage overlap each other
        too, so a fanned-out stage alone scores above 0."""
        busy = self._last_run_busy_s
        if busy <= 0 or self._last_run_active_s <= 0:
            return 0.0
        return max(0.0, 1.0 - self._last_run_active_s / busy)

    def run(self, spec: PipelineSpec) -> list[PipelineTask] | None:
        if not spec.stages:
            return list(spec.input_data) if spec.config.return_last_stage_outputs else None
        # the run's span rides the contextvar stack; worker threads start
        # under a copy of this context (_start_worker), so their spans
        # parent onto it
        with traced_span("pipeline.run", runner="pipelined", stages=len(spec.stages)):
            return self._run_pipelined(spec)

    def _run_pipelined(self, spec: PipelineSpec) -> list[PipelineTask] | None:
        t_start = time.monotonic()
        self._abort.clear()
        self._stop.clear()
        self._abort_exc = None
        self.plans = []
        self.dlq = DeadLetterQueue()  # lazy: writes nothing unless a drop happens
        cfg = spec.config
        self._node = NodeInfo(
            node_id="local",
            num_cpus=cfg.num_cpus or float(os.cpu_count() or 1),
            num_gpus=discover_gpus(cfg, spec.stages),
        )

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
        queues = [_TaskQueue(self._queue_capacity(1, cfg)) for _ in spec.stages]
        queues[0].set_capacity(max(queues[0].capacity, len(spec.input_data)))
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
        budget = Budget(cpus=self._node.num_cpus, gpus=float(self._node.num_gpus))
        self._apply_allocation(runtimes, self._plan(runtimes, budget), cfg)
        publisher = LiveStatusPublisher.from_env(runner="pipelined")
        last_replan = time.monotonic()
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
                now = time.monotonic()
                if now - last_replan >= self.replan_interval_s:
                    self._apply_allocation(runtimes, self._plan(runtimes, budget), cfg)
                    self._export_flow(runtimes)
                    last_replan = now
                if publisher is not None:
                    publisher.maybe_publish(lambda: self._build_live_snapshot(runtimes))
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
                for w in rt.workers:
                    w.thread.join(timeout=30.0)
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
            self._export_flow(runtimes)  # the last tick (short runs too)
            self._record_run_stats(runtimes)
            if publisher is not None:
                try:
                    publisher.finalize(self._build_live_snapshot(runtimes))
                except Exception:
                    logger.exception("final live-status publish failed")

        if self._abort_exc is not None:
            raise self._abort_exc
        return outputs if cfg.return_last_stage_outputs else None

    def _should_stop(self) -> bool:
        return self._abort.is_set() or self._stop.is_set()

    # -- worker side ---------------------------------------------------------
    def _worker_loop(self, rt: _StageRuntime, w: _Worker) -> None:
        if not self._ensure_setup(rt, w):
            return
        bs = max(1, rt.stage.batch_size)
        attempts = max(1, rt.spec.num_run_attempts)

        def should_stop() -> bool:
            return self._should_stop() or w.stop.is_set()

        while True:
            batch = rt.in_q.get_batch(bs, should_stop, self.batch_linger_s)
            if batch is None:
                return
            with rt.lock:
                rt.dispatched += 1
                batch_id = rt.next_batch_id
                rt.next_batch_id += 1
            result = self._run_batch(rt, batch, batch_id, attempts, w.meta.worker_id)
            if result is _ABORTED:
                return
            if result:
                rt.emit(result)

    def _ensure_setup(self, rt: _StageRuntime, w: _Worker) -> bool:
        """The first thread in runs the stage's setup; the others wait for
        it. False when setup failed or the run is aborting."""
        with rt.lock:
            claim = rt.setup_state == "pending"
            if claim:
                rt.setup_state = "running"
        if claim:
            try:
                with traced_span(f"stage.{rt.stage.name}.setup"):
                    rt.stage.setup_on_node(self._node, w.meta)
                    rt.stage.setup(w.meta)
                rt.setup_state = "ok"
                return True
            except Exception as e:
                rt.setup_state = "failed"
                self._trigger_abort(e)
                return False
            finally:
                rt.setup_done.set()
        while not rt.setup_done.wait(0.1):
            if self._abort.is_set():
                return False
        return rt.setup_state == "ok"

    def _run_batch(self, rt: _StageRuntime, batch: list, batch_id: int, attempts: int, worker_id: str):
        stage = rt.stage
        for attempt in range(attempts):
            t0 = time.monotonic()
            with rt.lock:
                # registered before the chaos sites and process_data, so a
                # hang shows as an aging in-flight batch from its first second
                rt.inflight[batch_id] = {"started": t0, "worker": worker_id, "attempt": attempt + 1}
            try:
                chaos.fire(chaos.SITE_WORKER_CRASH)  # kind=crash: os._exit
                chaos.fire(chaos.SITE_WORKER_HANG)  # kind=hang: stuck batch
                with traced_span(f"stage.{stage.name}.process", batch_size=len(batch)):
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
                elapsed = self._account(rt, t0, completed=True)
                record_stage_busy(stage.name, elapsed)
                self.metrics.observe_result(stage.name, elapsed, len(result or []))
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
            finally:
                with rt.lock:
                    rt.inflight.pop(batch_id, None)
        return []  # unreachable; attempts >= 1

    @staticmethod
    def _account(rt: _StageRuntime, t0: float, *, completed: bool) -> float:
        """Fold one attempt's busy time into the stage; returns it."""
        t1 = time.monotonic()
        with rt.lock:
            rt.busy_s += t1 - t0
            rt.first_start = t0 if rt.first_start is None else min(rt.first_start, t0)
            rt.last_end = t1 if rt.last_end is None else max(rt.last_end, t1)
            if completed:
                rt.samples.append((t1, t1 - t0))
                rt.completed += 1
        return t1 - t0

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

    # -- planning and scaling ------------------------------------------------
    def _plan(self, runtimes: list[_StageRuntime], budget: Budget) -> list[int]:
        states = []
        for rt in runtimes:
            spec = rt.spec
            if _single_worker_only(spec.stage):
                spec = replace(spec, num_workers=1)
            elif spec.num_workers is None:
                cap = spec.max_workers
                spec = replace(spec, max_workers=min(cap, self.thread_cap) if cap else self.thread_cap)
            states.append(StageScaleState(
                spec=spec,
                throughput_per_worker=rt.throughput_per_worker(_RATE_WINDOW_S),
                queued=len(rt.in_q),
            ))
        targets = plan_allocation(states, budget)
        if not self.plans or self.plans[-1] != targets:
            self.plans.append(targets)
        return targets

    def _apply_allocation(self, runtimes: list[_StageRuntime], targets: list[int], cfg: PipelineConfig) -> None:
        for rt, target in zip(runtimes, targets):
            if rt.finalized:
                continue
            if rt.in_q.drained and rt.setup_state != "pending":
                # the stage is winding down: no new workers. A stage never
                # started (empty input) still gets one below, so the setup ->
                # destroy lifecycle runs for every stage
                continue
            target = max(1, target)
            live = rt.live_workers()
            for _ in range(target - len(live)):
                self._start_worker(rt)
            for w in live[target:]:  # scale down: drain-and-exit
                w.stop.set()
            rt.in_q.set_capacity(self._queue_capacity(target, cfg))

    def _queue_capacity(self, workers: int, cfg: PipelineConfig) -> int:
        if self.queue_capacity is not None:
            return self.queue_capacity
        return max(cfg.max_queued_lower_bound, int(cfg.max_queued_multiplier * workers))

    def _start_worker(self, rt: _StageRuntime) -> None:
        widx = rt.next_worker_idx
        rt.next_worker_idx += 1
        meta = WorkerMetadata(
            worker_id=f"{rt.stage.name}-pipe-{widx}",
            stage_name=rt.stage.name,
            node=self._node,
            allocation=rt.stage.resources,
            gpu_ids=tuple(range(self._node.num_gpus)) if rt.stage.resources.uses_gpu else (),
        )
        w = _Worker(meta=meta)
        # the caller's context (the run's span) into the worker thread
        ctx = contextvars.copy_context()
        w.thread = threading.Thread(target=ctx.run, args=(self._worker_loop, rt, w), daemon=True,
                                    name=meta.worker_id)
        rt.workers.append(w)
        w.thread.start()

    def _finalize_stage(self, rt: _StageRuntime) -> None:
        if rt.setup_state == "ok" and not rt.destroyed:
            rt.destroyed = True
            try:
                rt.stage.destroy()
            except Exception:
                logger.exception("stage %s destroy failed", rt.stage.name)
        rt.finalized = True

    def _export_flow(self, runtimes: list[_StageRuntime]) -> None:
        """One replan tick of per-stage queue depth and busy fraction into
        stage_timer's stage flow (and its gauges)."""
        now = time.monotonic()
        for rt in runtimes:
            workers = len(rt.live_workers())
            with rt.lock:
                busy = rt.busy_s
            frac = rt.busy_frac(now, busy, workers)
            rt.tick_busy_s = busy
            rt.tick_t = now
            record_stage_flow(rt.stage.name, queue_depth=len(rt.in_q), busy_frac=frac, workers=workers)

    def _build_live_snapshot(self, runtimes: list[_StageRuntime]) -> dict:
        """One live-status snapshot from state the runner already keeps:
        counters, the batch-time window and the in-flight registry."""
        now = time.monotonic()
        stages: dict[str, dict] = {}
        for rt in runtimes:
            workers = len(rt.live_workers())
            with rt.lock:
                inflight = sorted(rt.inflight.items(), key=lambda kv: kv[1]["started"])[:MAX_INFLIGHT_PER_STAGE]
                durs = sorted(d for (_t, d) in rt.samples)
                busy = rt.busy_s
                counts = (rt.dispatched, rt.completed, rt.errored, rt.dead_lettered)
            stages[rt.stage.name] = {
                "queue_depth": len(rt.in_q),
                "busy_frac": round(rt.busy_frac(now, busy, workers), 4),
                "workers": workers,
                "dispatched": counts[0],
                "completed": counts[1],
                "errored": counts[2],
                "dead_lettered": counts[3],
                "finished": rt.finalized,
                "p50_s": round(durs[len(durs) // 2], 4) if durs else 0.0,
                "p99_s": round(durs[min(len(durs) - 1, int(len(durs) * 0.99))], 4) if durs else 0.0,
                "inflight": [
                    {"batch_id": bid, "age_s": round(now - info["started"], 3), "attempt": info["attempt"],
                     "worker": info["worker"]}
                    for bid, info in inflight
                ],
            }
        return {"stages": stages}

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
                    # worker threads started over the run
                    "workers": rt.next_worker_idx,
                }
                self.stage_counts[rt.stage.name] = counts
            logger.info(
                "stage %s: %d dispatched, %d completed, %d errored, %d dead-lettered (%.2fs busy, %d workers)",
                rt.stage.name, counts["dispatched"], counts["completed"], counts["errored"],
                counts["dead_lettered"], rt.busy_s, counts["workers"],
            )
        self._last_run_active_s = max(ends) - min(starts) if starts else 0.0
        self.metrics.set_overlap_frac(self.overlap_frac)
        if self.dlq is not None and self.dlq.recorded:
            logger.error("%d dropped batch(es) persisted to the dead-letter queue: %s", self.dlq.recorded, self.dlq.run_dir)


def _single_worker_only(stage: Stage) -> bool:
    """Device stages (a GPU claim, or a model that pins dispatch) and stages
    not declared ``thread_safe`` run with exactly one worker thread."""
    if stage.resources.uses_gpu:
        return True
    model = stage.model
    if model is not None and getattr(model, "pin_to_single_worker", True):
        return True
    return not getattr(stage, "thread_safe", False)


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

    # host inventory until the mesh layer owns device counts (ROADMAP queue A item 7)
    # curate-lint: disable=hardcoded-device-count
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(
            f"stage(s) {wanting} request a GPU and this host has no CUDA device; "
            "build them with device='cpu' to run on the CPU"
        )
    return count
