"""StreamingRunner: the streaming engine's orchestration loop (port of
``cosmos_curate_tpu/engine/runner.py``, its single-host part).

Refs, never payloads, move between per-stage pools (engine/pool.py: spawned
processes for CPU stages, a driver thread for each GPU stage) through the
shared-memory object store (engine/object_store.py). Input queues are
bounded (``max(lower bound, multiplier x pool size)``, the config's two
knobs), so a full downstream stage holds its producers back, and inputs are
seeded only while the store has headroom. A stage may emit any number of
tasks. A failing batch is re-run up to ``num_run_attempts`` times, then
dead-lettered (engine/dead_letter.py); a dead worker's batch is re-queued
under a separate worker-death budget and the worker replaced; a process
worker past its batch's ``batch_timeout_s`` is killed; workers recycle after
``worker_max_lifetime_m``; the autoscaler (engine/autoscaler.py) re-plans
the pools every ``autoscale_interval_s``. STREAMING keeps every pool live
at once; BATCH runs stage by stage.

Each stage gets a driver span (``stage.<name>``) whose traceparent every
batch carries, so worker spans join the run's trace; the loop publishes the
live status (observability/live_status.py) from its own state. After a run,
``stage_counts``, ``stage_times``, ``worker_pids``, ``worker_ready_s`` (spawn
to ready, per process worker) and ``store_stats`` describe it: every
object that went through the store (``objects``, ``bytes_put``: the seeded
inputs and every stage's outputs, whichever process put them), the peak
bytes in flight, and the driver's own puts and how many took the native
framing (``driver_puts``, ``driver_native_puts``, ``driver_put_bytes``).

Not ported, named here and in ROADMAP queue A item 15: the cross-node data
plane (``maybe_create_manager``: node agents, their budgets, placement and
prefetch / push-ahead bookkeeping, remote final-output fetches), the
``LineageTracker`` and node-loss reconstruction, and the per-node planner
(``plan_node_allocation``). With ``CURATE_ENGINE_DRIVER_PORT`` set, which
would select that plane, ``run`` raises ``NotImplementedError``; it never
runs single-host instead.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
from collections import deque
from dataclasses import dataclass, field
from dataclasses import replace as dc_replace

from cosmos_curate_tpu_torch.core.pipeline import ExecutionMode, PipelineSpec
from cosmos_curate_tpu_torch.core.pipelined_runner import discover_gpus
from cosmos_curate_tpu_torch.core.runner import ENGINE_DRIVER_PORT_ENV, REMOTE_PLANE, RunnerInterface
from cosmos_curate_tpu_torch.core.stage import NodeInfo, StageSpec, fill_default_lifetimes
from cosmos_curate_tpu_torch.core.tasks import PipelineTask
from cosmos_curate_tpu_torch.engine import object_store
from cosmos_curate_tpu_torch.engine.autoscaler import Budget, StageScaleState, plan_allocation
from cosmos_curate_tpu_torch.engine.dead_letter import DeadLetterQueue
from cosmos_curate_tpu_torch.engine.metrics import get_metrics
from cosmos_curate_tpu_torch.engine.pool import BasePool, PrewarmPool, ProcessPool, make_pool
from cosmos_curate_tpu_torch.engine.worker import ReadyMsg, ResultMsg
from cosmos_curate_tpu_torch.observability import tracing
from cosmos_curate_tpu_torch.observability.live_status import MAX_INFLIGHT_PER_STAGE, LiveStatusPublisher
from cosmos_curate_tpu_torch.observability.stage_timer import DISPATCH_DUMP_DIR_ENV, merge_new_dumped_summaries
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

PREWARM_ENV = "CURATE_PREWARM"


@dataclass
class _Batch:
    batch_id: int
    stage_idx: int
    refs: list[object_store.ObjectRef]
    attempts: int = 0
    # worker deaths are infrastructure failures, budgeted apart from the
    # stage's own exceptions; the cap still bounds a batch that kills every
    # worker it touches
    worker_deaths: int = 0
    # set at dispatch: the worker that holds the batch, and (with the
    # stage's batch_timeout_s) when that worker is presumed hung
    worker_id: str = ""
    deadline: float | None = None
    # dispatch instant: the live status reports in-flight ages from it
    dispatched_at: float | None = None


# a batch survives this many worker deaths before it is dropped
MAX_WORKER_DEATHS_PER_BATCH = 3


@dataclass
class _StageState:
    spec: StageSpec
    pool: BasePool
    in_queue: deque = field(default_factory=deque)  # ObjectRefs of tasks
    retry_queue: deque = field(default_factory=deque)  # _Batch objects
    dispatched: int = 0
    completed: int = 0
    errored_batches: int = 0
    dead_lettered: int = 0

    def queue_limit(self, lower: int, mult: float) -> int:
        return max(lower, int(mult * max(1, self.pool.num_workers())))


class StreamingRunner(RunnerInterface):
    def __init__(self, *, poll_interval_s: float = 0.02) -> None:
        self.metrics = get_metrics()
        self.poll_interval_s = poll_interval_s
        # run-scoped dead-letter queue, made per run() (batch mode's
        # stage-by-stage sub-runs share one run dir)
        self.dlq: DeadLetterQueue | None = None
        # stage name -> summed worker busy seconds
        self.stage_times: dict[str, float] = {}
        self.stage_counts: dict[str, dict] = {}
        self.pipeline_wall_s = 0.0
        # every process worker (and prewarmed spare) a run started, and each
        # process worker's seconds from spawn to ready
        self.worker_pids: set[int] = set()
        self.worker_ready_s: list[float] = []
        self.store_stats: dict = {}
        self._stage_durs: list[deque] = []

    # ------------------------------------------------------------------
    def run(self, spec: PipelineSpec) -> list[PipelineTask] | None:
        if os.environ.get(ENGINE_DRIVER_PORT_ENV):
            raise NotImplementedError(f"{ENGINE_DRIVER_PORT_ENV} is set, which selects {REMOTE_PLANE}, not ported yet")
        if not spec.stages:
            return list(spec.input_data) if spec.config.return_last_stage_outputs else None
        self.dlq = DeadLetterQueue()  # lazy: writes nothing unless a batch drops
        self.worker_pids = set()
        self.worker_ready_s = []
        self.store_stats = {"objects": 0, "bytes_put": 0, "peak_bytes": 0}
        stats0 = object_store.stats()
        t0 = time.monotonic()
        try:
            with tracing.traced_span("pipeline.run", runner="streaming", stages=len(spec.stages)):
                if spec.config.execution_mode is ExecutionMode.BATCH:
                    return self._run_batch(spec)
                return self._run_streaming(spec, spec.stages)
        finally:
            self.pipeline_wall_s = time.monotonic() - t0
            stats1 = object_store.stats()
            self.store_stats.update({f"driver_{k}": stats1[k] - stats0[k] for k in ("puts", "native_puts", "put_bytes")})
            # workers hand their dispatch aggregates back through their
            # at-exit dumps: fold whatever landed into this process's
            path = os.environ.get(DISPATCH_DUMP_DIR_ENV)
            if path:
                merge_new_dumped_summaries(path)

    # ------------------------------------------------------------------
    def _run_batch(self, spec: PipelineSpec) -> list[PipelineTask] | None:
        """Stage by stage, each a one-stage streaming run. Intermediate
        stages always return their outputs (the next stage's inputs);
        ``return_last_stage_outputs`` governs the last one only."""
        tasks: list[PipelineTask] = list(spec.input_data)
        inner_cfg = dc_replace(spec.config, return_last_stage_outputs=True)
        counts: dict[str, dict] = {}
        for i, stage_spec in enumerate(spec.stages):
            cfg = spec.config if i == len(spec.stages) - 1 else inner_cfg
            sub = PipelineSpec(input_data=tasks, stages=[stage_spec], config=cfg)
            tasks = self._run_streaming(sub, [stage_spec]) or []
            counts.update(self.stage_counts)
        self.stage_counts = counts
        return tasks if spec.config.return_last_stage_outputs else None

    # ------------------------------------------------------------------
    def _run_streaming(self, spec: PipelineSpec, stage_specs: list[StageSpec]) -> list[PipelineTask] | None:
        cfg = spec.config
        stage_specs = [fill_default_lifetimes(s) for s in stage_specs]
        object_store.cleanup_stale_segments()
        node = NodeInfo(node_id="local", num_cpus=cfg.num_cpus or float(os.cpu_count() or 1),
                        num_gpus=discover_gpus(cfg, stage_specs))
        mp_results: mp.Queue = mp.get_context("spawn").Queue()
        thread_results: queue.Queue = queue.Queue()
        budget = Budget(cpus=node.num_cpus, gpus=float(node.num_gpus))
        # warm spares prepay a worker's spawn and imports; CURATE_PREWARM=0
        # disables them
        n_prewarm = int(os.environ.get(PREWARM_ENV, "2"))
        any_process_stage = any(not s.stage.resources.uses_gpu for s in stage_specs)
        prewarm = PrewarmPool(mp_results, size=n_prewarm) if n_prewarm > 0 and any_process_stage else None
        if prewarm is not None:
            self.worker_pids.update(prewarm.pids())
        states = [
            _StageState(spec=s, pool=make_pool(s, node, mp_results, thread_results, pool_id=i, prewarm=prewarm))
            for i, s in enumerate(stage_specs)
        ]
        store = object_store.StoreBudget(capacity_bytes=int(_host_memory_bytes() *
                                                            cfg.streaming.object_store_fraction))
        # segments this run and its workers create carry this pid
        os.environ.setdefault("CURATE_STORE_OWNER", str(os.getpid()))
        publisher = LiveStatusPublisher.from_env(runner="streaming")
        self._stage_durs = [deque(maxlen=128) for _ in states]

        # inputs are seeded inside the loop, gated on the store's headroom
        # and the first stage's queue bound: a huge input list must not fill
        # /dev/shm up front
        pending_inputs = iter(spec.input_data)
        inputs_exhausted = not spec.input_data
        self._apply_allocation(states, budget, cfg)

        batches: dict[int, _Batch] = {}
        next_batch_id = 0
        outputs: list[PipelineTask] = []
        last_autoscale = time.monotonic()
        pending_setup_errors: list[str] = []
        lower, mult = cfg.max_queued_lower_bound, cfg.max_queued_multiplier

        # one driver span per stage, made right before the try whose
        # finally ends them; every batch carries its traceparent
        stage_spans = []
        for st in states:
            span = tracing.start_span(f"stage.{st.spec.name}", stage=st.spec.name)
            stage_spans.append(span)
            st.pool.trace_context = tracing.format_traceparent(span)

        try:
            while True:
                progressed = False
                # 0. seed inputs while the store has headroom
                if not inputs_exhausted:
                    limit0 = states[0].queue_limit(lower, mult)
                    while len(states[0].in_queue) < limit0 and store.has_headroom():
                        task = next(pending_inputs, None)
                        if task is None:
                            inputs_exhausted = True
                            break
                        ref = object_store.put(task)
                        self._count_object(ref)
                        store.account(ref)
                        states[0].in_queue.append(ref)
                        progressed = True
                # 1. drain results
                for msg in self._drain(mp_results, thread_results):
                    progressed = True
                    if isinstance(msg, ReadyMsg):
                        self._on_ready(states, msg, pending_setup_errors)
                        continue
                    self._on_result(states, batches, msg, outputs, store, cfg)
                if pending_setup_errors:
                    raise RuntimeError("stage worker setup failed:\n" + "\n".join(pending_setup_errors))
                # 2. kill workers whose batch blew its deadline, so the reap
                # right after re-queues the batch; reap dead and draining
                progressed |= self._expire_hung_batches(states, batches)
                progressed |= self._reap_dead_workers(states, batches, store)
                for st in states:
                    if isinstance(st.pool, ProcessPool):
                        st.pool.reap_draining()
                # 3. dispatch
                for i, st in enumerate(states):
                    if i + 1 < len(states) and len(states[i + 1].in_queue) >= states[i + 1].queue_limit(lower, mult):
                        continue  # backpressure: the next stage's queue is full
                    bs = max(1, st.spec.stage.batch_size)
                    idle = []
                    for w in st.pool.idle_workers():
                        if st.pool.lifetime_expired(w):
                            st.pool.stop_worker(w)  # recycle in place
                            self._start_worker(st.pool)
                            continue
                        idle.append(w)
                    while idle:
                        if st.retry_queue:  # a failed batch keeps its identity
                            batch = st.retry_queue.popleft()
                        elif st.in_queue:
                            refs = [st.in_queue.popleft() for _ in range(min(bs, len(st.in_queue)))]
                            batch = _Batch(next_batch_id, i, refs)
                            next_batch_id += 1
                        else:
                            break
                        w = idle.pop(0)
                        batch.worker_id = w.worker_id
                        timeout = st.spec.batch_timeout_s
                        batch.dispatched_at = time.monotonic()
                        batch.deadline = batch.dispatched_at + timeout if timeout else None
                        batches[batch.batch_id] = batch
                        st.pool.submit(w, batch.batch_id, batch.refs)
                        st.dispatched += 1
                        progressed = True
                # 4. autoscale
                now = time.monotonic()
                if now - last_autoscale >= cfg.streaming.autoscale_interval_s:
                    self._apply_allocation(states, budget, cfg)
                    last_autoscale = now
                # 5. metrics, live status, completion
                for st in states:
                    ready = len([w for w in st.pool.workers.values() if w.ready])
                    self.metrics.set_pool_state(st.spec.name, ready, st.pool.num_workers() - ready, len(st.in_queue))
                self.metrics.set_store_bytes(store.used)
                self.store_stats["peak_bytes"] = max(self.store_stats["peak_bytes"], store.used)
                if publisher is not None:
                    publisher.maybe_publish(lambda: self._build_live_snapshot(states, batches, store))
                if inputs_exhausted and not batches and all(not st.in_queue and not st.retry_queue for st in states):
                    break
                if not progressed:
                    time.sleep(self.poll_interval_s)
            # completed counts logical batches, so completed + errored
            # accounts for every dispatched batch once
            self.stage_counts = {
                st.spec.name: {"dispatched": st.dispatched, "completed": st.completed,
                               "errored": st.errored_batches, "dead_lettered": st.dead_lettered,
                               "workers": st.pool.workers_started}
                for st in states
            }
            for name, c in self.stage_counts.items():
                logger.info("stage %s: %d dispatched, %d completed, %d errored, %d dead-lettered", name,
                            c["dispatched"], c["completed"], c["errored"], c["dead_lettered"])
            if self.dlq is not None and self.dlq.recorded:
                logger.error("%d dropped batch(es) persisted to the dead-letter queue: %s; inspect with "
                             "`cosmos-curate-tpu-torch dlq list`", self.dlq.recorded, self.dlq.run_dir)
            return outputs if cfg.return_last_stage_outputs else None
        finally:
            if publisher is not None:
                # the terminal snapshot (state finished): a reader tells an
                # ended runner from a wedged publisher
                try:
                    publisher.finalize(self._build_live_snapshot(states, batches, store))
                except Exception:
                    logger.exception("final live-status publish failed")
            for batch in batches.values():  # in flight on an exception exit
                for r in batch.refs:
                    store.release(r)
            for st in states:
                for r in st.in_queue:
                    store.release(r)
                for batch in st.retry_queue:
                    for r in batch.refs:
                        store.release(r)
                st.pool.shutdown()
                if isinstance(st.pool, ProcessPool):
                    self.worker_pids.update(p for p in st.pool.pids.values() if p is not None)
            if prewarm is not None:
                self.worker_pids.update(prewarm.pids())
                prewarm.shutdown()
            for st, span in zip(states, stage_spans):
                span.set_attribute("dispatched", st.dispatched)
                span.set_attribute("completed", st.completed)
                span.set_attribute("errored", st.errored_batches)
                tracing.end_span(span)

    # ------------------------------------------------------------------
    def _count_object(self, ref: object_store.ObjectRef) -> None:
        self.store_stats["objects"] += 1
        self.store_stats["bytes_put"] += ref.total_size

    def _start_worker(self, pool: BasePool) -> None:
        pool.start_worker()
        if isinstance(pool, ProcessPool):
            self.worker_pids.update(p for p in pool.pids.values() if p is not None)

    def _build_live_snapshot(self, states, batches, store) -> dict:
        """One live-status snapshot from the loop's own state: per-stage
        queues and worker occupancy, every in-flight batch with its age and
        budgets, and the store's bytes in flight."""
        now = time.monotonic()
        by_stage: dict[int, list] = {}
        for b in batches.values():
            by_stage.setdefault(b.stage_idx, []).append(b)
        stages: dict[str, dict] = {}
        for i, st in enumerate(states):
            workers = list(st.pool.workers.values())
            busy = sum(1 for w in workers if w.busy_batch is not None)
            inflight = sorted(by_stage.get(i, ()), key=lambda b: b.dispatched_at or now)[:MAX_INFLIGHT_PER_STAGE]
            durs = sorted(self._stage_durs[i]) if i < len(self._stage_durs) else []
            stages[st.spec.name] = {
                "queue_depth": len(st.in_queue),
                "retry_queue": len(st.retry_queue),
                "busy_frac": round(busy / max(1, len(workers)), 4),
                "workers": len(workers),
                "dispatched": st.dispatched,
                "completed": st.completed,
                "errored": st.errored_batches,
                "dead_lettered": st.dead_lettered,
                "p50_s": round(durs[len(durs) // 2], 4) if durs else 0.0,
                "p99_s": round(durs[min(len(durs) - 1, int(len(durs) * 0.99))], 4) if durs else 0.0,
                "inflight": [
                    {
                        "batch_id": b.batch_id,
                        "age_s": round(now - (b.dispatched_at or now), 3),
                        "attempt": b.attempts + 1,
                        "worker_deaths": b.worker_deaths,
                        "worker": b.worker_id,
                        "deadline_in_s": round(b.deadline - now, 3) if b.deadline is not None else None,
                    }
                    for b in inflight
                ],
            }
        return {"stages": stages, "store_bytes": store.used}

    def _on_ready(self, states, msg: ReadyMsg, errors: list[str]) -> None:
        for st in states:
            w = st.pool.workers.get(msg.worker_id)
            if w is None:
                continue
            if msg.error:
                errors.append(f"[{st.spec.name}/{msg.worker_id}] {msg.error}")
            else:
                w.ready = True
                if isinstance(st.pool, ProcessPool):
                    self.worker_ready_s.append(time.monotonic() - w.started_at)
            return

    def _on_result(self, states, batches, msg: ResultMsg, outputs, store, cfg) -> None:
        batch = batches.pop(msg.batch_id, None)
        if batch is None:
            # a late result of a batch the reaper already re-queued (the
            # worker answered, then died): the re-run wins, and this
            # result's outputs must not leak
            for r in msg.out_refs:
                object_store.delete(r)
            return
        st = states[batch.stage_idx]
        w = st.pool.workers.get(msg.worker_id)
        if w is not None:
            w.busy_batch = None
            w.batches_done += 1
        if msg.error is not None:
            self.metrics.observe_error(st.spec.name)
            batch.attempts += 1
            if batch.attempts < max(1, st.spec.num_run_attempts):
                logger.warning("stage %s batch %d failed (attempt %d), retrying:\n%s", st.spec.name,
                               batch.batch_id, batch.attempts, _tail(msg.error))
                st.retry_queue.append(batch)
            else:
                logger.error("stage %s batch %d failed permanently, dropping %d tasks:\n%s", st.spec.name,
                             batch.batch_id, len(batch.refs), _tail(msg.error))
                st.errored_batches += 1
                # persisted BEFORE the refs are released (the payloads die
                # with them)
                self._dead_letter(st, batch, reason=f"num_run_attempts ({st.spec.num_run_attempts}) exhausted",
                                  error=msg.error)
                for r in batch.refs:
                    store.release(r)
            return
        st.pool.record_sample(msg.process_time_s)
        self._stage_durs[batch.stage_idx].append(msg.process_time_s)
        self.stage_times[st.spec.name] = self.stage_times.get(st.spec.name, 0.0) + msg.process_time_s
        self.metrics.observe_result(st.spec.name, msg.process_time_s, len(msg.out_refs), msg.deserialize_time_s)
        nxt = batch.stage_idx + 1
        for r in msg.out_refs:
            self._count_object(r)
            if nxt < len(states):
                store.account(r)  # the queue bounds and input gating hold back
                states[nxt].in_queue.append(r)
                continue
            # final outputs stay out of the ledger: they are freed here, and
            # accounting them would pin ``used`` and stall the seeding
            if cfg.return_last_stage_outputs:
                outputs.append(object_store.get(r))
            object_store.delete(r)
        st.completed += 1
        for r in batch.refs:
            store.release(r)

    _MAX_SETUP_DEATHS = 3

    def _expire_hung_batches(self, states, batches) -> bool:
        """A batch past its ``batch_timeout_s`` means its worker is presumed
        hung: the worker is killed, and the dead-worker reap re-queues the
        batch under its worker-death budget. Process workers only: a device
        stage's thread cannot be killed."""
        now = time.monotonic()
        progressed = False
        for batch in batches.values():
            if batch.deadline is None or now < batch.deadline:
                continue
            st = states[batch.stage_idx]
            timeout = st.spec.batch_timeout_s or 0.0
            batch.deadline = None  # once per dispatch: a retry re-arms it
            w = st.pool.workers.get(batch.worker_id)
            if w is None or w.busy_batch != batch.batch_id:
                continue  # the worker already died or recycled
            if w.proc is None:
                logger.error("stage %s batch %d exceeded batch_timeout_s=%.1fs on in-process worker %s; threads "
                             "cannot be killed: waiting", st.spec.name, batch.batch_id, timeout, w.worker_id)
                continue
            logger.warning("stage %s batch %d exceeded batch_timeout_s=%.1fs; killing hung worker %s",
                           st.spec.name, batch.batch_id, timeout, w.worker_id)
            self.metrics.observe_error(st.spec.name)
            try:
                w.proc.kill()  # SIGKILL: a hung worker may ignore SIGTERM
            except (OSError, AttributeError):
                logger.debug("kill failed for %s", w.worker_id, exc_info=True)
            progressed = True
        return progressed

    def _dead_letter(self, stx, batch: _Batch, *, reason: str, error: str = "") -> None:
        """Persist a dropped batch's payloads and metadata. Runs BEFORE the
        refs are released; never raises (a DLQ failure degrades to a
        log-only drop)."""
        dlq = self.dlq
        if dlq is None or not dlq.enabled:
            return
        tasks, errs = [], []
        for r in batch.refs:
            try:
                tasks.append(object_store.get(r))
            except Exception as e:  # a partial entry beats none
                errs.append(f"{r.shm_name}: {e}")
        if dlq.record(stage_name=stx.spec.name, batch_id=batch.batch_id, tasks=tasks, attempts=batch.attempts,
                      worker_deaths=batch.worker_deaths, reason=reason, error=error, payload_errors=errs or None):
            stx.dead_lettered += 1

    def _reap_dead_workers(self, states, batches, store) -> bool:
        progressed = False
        for st in states:
            if not isinstance(st.pool, ProcessPool):
                continue
            for w in list(st.pool.workers.values()):
                proc = w.proc
                if proc is None or proc.is_alive():
                    continue
                logger.warning("worker %s died (exit %s)", w.worker_id, proc.exitcode)
                st.pool.workers.pop(w.worker_id, None)
                if not w.ready:
                    # died before it was ready: likely a setup crash; the
                    # cap stops a respawn loop when setup always fails
                    st.pool.setup_deaths += 1
                    if st.pool.setup_deaths >= self._MAX_SETUP_DEATHS:
                        raise RuntimeError(f"stage {st.spec.name}: {st.pool.setup_deaths} workers died during "
                                           f"setup (last exit {proc.exitcode}); aborting pipeline")
                if w.busy_batch is not None and w.busy_batch in batches:
                    _retry_or_drop(st, batches.pop(w.busy_batch), store,
                                   f"worker {w.worker_id} died processing it (poison batch?)",
                                   dead_letter=self._dead_letter)
                self._start_worker(st.pool)
                progressed = True
        return progressed

    def _apply_allocation(self, states, budget: Budget, cfg) -> None:
        window = cfg.streaming.speed_estimation_window_s
        scale_states = [
            StageScaleState(spec=st.spec, throughput_per_worker=st.pool.throughput_per_worker(window),
                            queued=len(st.in_queue))
            for st in states
        ]
        targets = plan_allocation(scale_states, budget)
        for st, target in zip(states, targets):
            cur = st.pool.num_workers()
            for _ in range(max(0, target - cur)):
                self._start_worker(st.pool)
            if target < cur:
                for w in st.pool.idle_workers()[: cur - target]:  # idle workers only
                    st.pool.stop_worker(w)

    @staticmethod
    def _drain(mp_q, t_q) -> list:
        out = []
        for q_ in (mp_q, t_q):
            while True:
                try:
                    out.append(q_.get_nowait())
                except queue.Empty:
                    break
                except (OSError, EOFError, ValueError):
                    break  # the queue was torn down mid-drain (shutdown)
        return out


def _retry_or_drop(stx, batch: _Batch, store, reason: str, *, dead_letter=None) -> None:
    """A worker death: re-queue the batch under its worker-death cap, else
    drop it loudly, dead-lettering it before its refs are released."""
    batch.worker_deaths += 1
    if batch.worker_deaths <= MAX_WORKER_DEATHS_PER_BATCH:
        logger.warning("batch %d: %s; re-running (%d/%d infra failures)", batch.batch_id, reason,
                       batch.worker_deaths, MAX_WORKER_DEATHS_PER_BATCH)
        stx.retry_queue.append(batch)
        return
    logger.error("batch %d dropped after %d infra failures (%s): %d tasks lost", batch.batch_id,
                 batch.worker_deaths, reason, len(batch.refs))
    stx.errored_batches += 1
    if dead_letter is not None:
        dead_letter(stx, batch, reason=reason)
    for r in batch.refs:
        store.release(r)


def _host_memory_bytes() -> int:
    """The host's physical memory (the reference asks psutil and assumes
    8 GiB without it; sysconf needs no package)."""
    try:
        return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    except (OSError, ValueError):
        return 8 << 30


def _tail(s: str, n: int = 2000) -> str:
    return s if len(s) <= n else "…" + s[-n:]
