"""StreamingRunner: the streaming engine's orchestration loop (port of
``cosmos_curate_tpu/engine/runner.py``).

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

The cross-node plane (engine/remote_plane.py) joins when
``CURATE_ENGINE_DRIVER_PORT`` is set: connected node agents' CPUs join the
budget, the per-node planner (``plan_node_allocation``) places CPU-stage
workers on them (GPU stages stay in the driver's threads), and dispatch
prefers the worker whose node already holds a batch's input bytes. Agent
outputs stay on their node: a driver consumer's inputs are pulled on a fetch
pool (never the loop), the next stage's inputs are pushed toward its planned
node ahead of demand (prefetch and push-ahead), and final outputs stream in
before their batch counts as done. A ``LineageTracker`` wraps the
location-aware deleter: when a node dies (heartbeat deadline or link loss),
the batches it held are re-run under a node-death budget apart from the
worker-death one, and outputs lost with it are re-made from their producing
batch's held inputs (``CURATE_RECONSTRUCT_DEPTH`` generations deep, at most
``CURATE_RECONSTRUCT_BUDGET`` re-runs a run); ``node_events``,
``objects_reconstructed``, ``node_plan``, ``remote_stats`` and
``object_plane`` describe it after the run.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
import multiprocessing as mp
import os
import queue
import time
from collections import deque
from dataclasses import dataclass, field
from dataclasses import replace as dc_replace

from cosmos_curate_tpu_torch.core.pipeline import ExecutionMode, PipelineSpec
from cosmos_curate_tpu_torch.core.pipelined_runner import discover_gpus
from cosmos_curate_tpu_torch.core.runner import RunnerInterface
from cosmos_curate_tpu_torch.core.stage import NodeInfo, StageSpec, fill_default_lifetimes
from cosmos_curate_tpu_torch.core.tasks import PipelineTask
from cosmos_curate_tpu_torch.engine import object_store
from cosmos_curate_tpu_torch.engine.autoscaler import (
    Budget,
    NodeBudget,
    StageScaleState,
    plan_allocation,
    plan_node_allocation,
)
from cosmos_curate_tpu_torch.engine.dead_letter import DeadLetterQueue
from cosmos_curate_tpu_torch.engine.lineage import (
    DEFAULT_RECONSTRUCT_BUDGET,
    DEFAULT_RECONSTRUCT_DEPTH,
    RECONSTRUCT_BUDGET_ENV,
    RECONSTRUCT_DEPTH_ENV,
    LineageTracker,
)
from cosmos_curate_tpu_torch.engine.metrics import get_metrics
from cosmos_curate_tpu_torch.engine.pool import BasePool, PrewarmPool, ProcessPool, make_pool
from cosmos_curate_tpu_torch.engine.remote_plane import maybe_create_manager
from cosmos_curate_tpu_torch.engine.worker import ReadyMsg, ResultMsg
from cosmos_curate_tpu_torch.observability import tracing
from cosmos_curate_tpu_torch.observability.live_status import MAX_INFLIGHT_PER_STAGE, LiveStatusPublisher
from cosmos_curate_tpu_torch.observability.stage_timer import (
    DISPATCH_DUMP_DIR_ENV,
    merge_new_dumped_summaries,
    object_plane_summaries,
    record_object_plane,
)
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
    # whole-node deaths budget apart again: a flaky node churning through a
    # run is the cluster's fault, never the batch's
    node_deaths: int = 0
    # set at dispatch: the worker that holds the batch, and (with the
    # stage's batch_timeout_s) when that worker is presumed hung
    worker_id: str = ""
    deadline: float | None = None
    # dispatch instant: the live status reports in-flight ages from it
    dispatched_at: float | None = None


# a batch survives this many worker deaths before it is dropped
MAX_WORKER_DEATHS_PER_BATCH = 3
# ... and this many whole-node deaths
MAX_NODE_DEATHS_PER_BATCH = 3

# driver-side prefetch-ahead: how many agent-owned segments may stream
# toward the driver at once while their consumer batch is still queued
PREFETCH_INFLIGHT_LIMIT = 6


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
        # -- the cross-node plane (None on a single-host run) -------------
        self._remote_mgr = None
        self._fetch_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._final_fetches: list = []
        # the per-node planner's preferred node per stage (the router's
        # affinity key) and its last stage -> {node -> workers} plan
        self._pref_node: list[str] | None = None
        self.node_plan: dict[str, dict[str, int]] = {}
        # driver-side prefetch-ahead: remote shm_name -> LOCAL accounted
        # copy, and what is still streaming in
        self._prefetched: dict[str, object_store.ObjectRef] = {}
        self._prefetch_inflight: set[str] = set()
        self._prefetch_done: queue.Queue = queue.Queue()
        # (target node, shm_name) push-ahead requests already issued
        self._pushed: set[tuple[str, str]] = set()
        # node-loss state: the lineage tracker, reconstruction re-runs
        # (negative batch ids) and their start times, batches parked while
        # their lost inputs re-materialize (batch_id -> (stage_idx, batch,
        # missing names)), and regenerations nobody waited for yet
        self._tracker: LineageTracker | None = None
        self._stage_names: list[str] = []
        self._recon: dict[int, object] = {}
        self._recon_started: dict[int, float] = {}
        self._recon_seq = 0
        self._recon_spent = 0
        self._recon_depth = 0
        self._recon_budget = 0
        self._lost_waiters: dict[int, tuple[int, _Batch, set]] = {}
        self._renamed: dict[str, object_store.ObjectRef] = {}
        # the run's receipts (the flight recorder's node_events section)
        self.node_events: list[dict] = []
        self.objects_reconstructed = 0
        self.reconstruction_seconds = 0.0
        self.remote_stats: dict = {}
        self.object_plane: dict = {}

    # ------------------------------------------------------------------
    def run(self, spec: PipelineSpec) -> list[PipelineTask] | None:
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
        # the cross-node plane, when CURATE_ENGINE_DRIVER_PORT is set:
        # connected agents' CPUs join the budget and CPU-stage pools place
        # workers on them
        remote_mgr = maybe_create_manager(thread_results, local_cpu_budget=node.num_cpus)
        budget = Budget(cpus=node.num_cpus + (remote_mgr.remote_cpus() if remote_mgr else 0.0),
                        gpus=float(node.num_gpus))
        # warm spares prepay a worker's spawn and imports; CURATE_PREWARM=0
        # disables them
        n_prewarm = int(os.environ.get(PREWARM_ENV, "2"))
        any_process_stage = any(not s.stage.resources.uses_gpu for s in stage_specs)
        prewarm = PrewarmPool(mp_results, size=n_prewarm) if n_prewarm > 0 and any_process_stage else None
        if prewarm is not None:
            self.worker_pids.update(prewarm.pids())
        states = [
            _StageState(spec=s, pool=make_pool(s, node, mp_results, thread_results, pool_id=i, prewarm=prewarm,
                                               remote_mgr=remote_mgr))
            for i, s in enumerate(stage_specs)
        ]
        self._remote_mgr = remote_mgr
        # node-loss lineage (cross-host only): the tracker wraps the
        # location-aware deleter; a release settles the ref's lineage and
        # may DEFER the physical delete while a live record still needs the
        # ref as a reconstruction input (ledger accounting is never deferred)
        self._tracker = None
        if remote_mgr is not None:
            self._tracker = LineageTracker(remote_mgr.release_data)
            self._recon_depth = int(os.environ.get(RECONSTRUCT_DEPTH_ENV, DEFAULT_RECONSTRUCT_DEPTH))
            self._recon_budget = int(os.environ.get(RECONSTRUCT_BUDGET_ENV, DEFAULT_RECONSTRUCT_BUDGET))
        deleter = self._tracker if self._tracker is not None else (remote_mgr.release_data if remote_mgr else None)
        store = object_store.StoreBudget(capacity_bytes=int(_host_memory_bytes() * cfg.streaming.object_store_fraction),
                                         deleter=deleter)
        # network transfers never run on the loop: localizing agent-owned
        # inputs for driver consumers and materializing remote final
        # outputs run on this pool, their completions drained like results
        self._fetch_pool = (concurrent.futures.ThreadPoolExecutor(max_workers=4, thread_name_prefix="obj-fetch")
                            if remote_mgr is not None else None)
        localize_done: queue.Queue = queue.Queue()
        # batch_id -> _Batch while on the fetch pool: in neither `batches`
        # nor any queue, so the exception-exit cleanup walks this too
        localizing: dict[int, _Batch] = {}
        prefetch_done: queue.Queue = queue.Queue()
        self._prefetch_done = prefetch_done
        # per-run state: batch mode reuses the runner for its sub-runs
        self._prefetched.clear()
        self._prefetch_inflight.clear()
        self._pushed.clear()
        self._pref_node = None
        self._stage_names = [s.name for s in stage_specs]
        self._recon = {}
        self._recon_started = {}
        self._recon_seq = 0
        self._recon_spent = 0
        self._lost_waiters = {}
        self._renamed = {}
        self.node_events = []
        self.objects_reconstructed = 0
        self.reconstruction_seconds = 0.0
        # (stage state, batch, remote refs, Future[values]): final-stage
        # batches whose remote outputs are streaming in; their inputs stay
        # held until the future lands (a failure re-runs the batch)
        self._final_fetches = []
        # segments this run and its workers create carry this pid
        os.environ.setdefault("CURATE_STORE_OWNER", str(os.getpid()))
        publisher = LiveStatusPublisher.from_env(runner="streaming")
        self._stage_durs = [deque(maxlen=128) for _ in states]

        # inputs are seeded inside the loop, gated on the store's headroom
        # and the first stage's queue bound: a huge input list must not fill
        # /dev/shm up front
        pending_inputs = iter(spec.input_data)
        inputs_exhausted = not spec.input_data
        self._apply_allocation(states, budget, cfg, remote_mgr=remote_mgr, local_node=node)

        batches: dict[int, _Batch] = {}
        next_batch_id = 0
        outputs: list[PipelineTask] = []
        last_autoscale = time.monotonic()
        pending_setup_errors: list[str] = []
        lower, mult = cfg.max_queued_lower_bound, cfg.max_queued_multiplier

        # one driver span per stage, made right before the try whose
        # finally ends them; every batch (local process, driver thread or a
        # worker on an agent) carries its traceparent
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
                        # push seeded inputs toward stage 0's planned node
                        self._maybe_prefetch(0, [ref], store)
                        progressed = True
                # 1. drain results
                for msg in self._drain(mp_results, thread_results):
                    progressed = True
                    if isinstance(msg, ReadyMsg):
                        self._on_ready(states, msg, pending_setup_errors)
                        continue
                    self._on_result(states, batches, msg, outputs, store, cfg)
                # 1b. finished localizations re-enter dispatch first
                while True:
                    try:
                        lb, err = localize_done.get_nowait()
                    except queue.Empty:
                        break
                    progressed = True
                    localizing.pop(lb.batch_id, None)
                    stx = states[lb.stage_idx]
                    if err is None:
                        stx.retry_queue.appendleft(lb)
                    else:
                        self._on_lost_or_failed_inputs(states, stx, lb, store, f"localizing inputs failed: {err}")
                # 1c. finished prefetch-aheads land in the local cache
                while True:
                    try:
                        pref_ref, local_ref, perr, transfer_s = prefetch_done.get_nowait()
                    except queue.Empty:
                        break
                    progressed = True
                    self._prefetch_inflight.discard(pref_ref.shm_name)
                    if perr is not None or local_ref is None:
                        # advisory: the demand localize still works
                        logger.debug("prefetch of %s failed: %s", pref_ref.shm_name, perr)
                        continue
                    store.account(local_ref)
                    self._prefetched[pref_ref.shm_name] = local_ref
                    record_object_plane(prefetches=1, prefetch_bytes=pref_ref.total_size,
                                        prefetch_transfer_s=transfer_s)
                    # oldest first: a copy whose batch went to the owner
                    # node instead must not pin the budget for the run
                    while len(self._prefetched) > 64:
                        store.release(self._prefetched.pop(next(iter(self._prefetched))))
                if pending_setup_errors:
                    raise RuntimeError("stage worker setup failed:\n" + "\n".join(pending_setup_errors))
                # 2. the failure detector: a newly declared node death
                # re-plans at once, so queued batches re-route while the
                # reap below re-queues the dead node's in-flight work. Then
                # kill workers whose batch blew its deadline, so the reap
                # right after re-queues the batch; reap dead and draining
                if remote_mgr is not None:
                    dead_events = remote_mgr.poll_node_deaths()
                    if dead_events:
                        progressed = True
                        for ev in dead_events:
                            self.metrics.observe_node_death(ev["node"])
                            # a rejoining agent starts with an empty cache
                            self._pushed = {k for k in self._pushed if k[0] != ev["node"]}
                        self.node_events.extend(dead_events)
                        self._apply_allocation(states, budget, cfg, remote_mgr=remote_mgr, local_node=node)
                        last_autoscale = time.monotonic()
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
                            # recycle in place, on the same node, so the
                            # per-node plan and the pools do not drift apart
                            node_id = st.pool.worker_node(w)
                            st.pool.stop_worker(w)
                            self._start_worker(st.pool, node_id=node_id if remote_mgr is not None else None)
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
                        # stage-affinity routing: the idle worker whose node
                        # holds the most input bytes, the next stage's
                        # planned node breaking ties
                        next_pref = (self._pref_node[i + 1]
                                     if self._pref_node is not None and i + 1 < len(self._pref_node) else None)
                        w = self._pick_worker(idle, batch.refs, remote_mgr, next_pref)
                        idle.remove(w)
                        if remote_mgr is not None and not BasePool.worker_node(w):
                            # prefetch-ahead may have copied inputs already
                            self._adopt_prefetched(batch, store)
                            if any(remote_mgr.owner_node(r) for r in batch.refs):
                                # a DRIVER consumer needs agent-owned bytes:
                                # pull them on the fetch pool, never this
                                # loop; the batch re-enters dispatch (1b).
                                # copy_context: the fetch spans parent onto
                                # the run's span
                                localizing[batch.batch_id] = batch
                                self._fetch_pool.submit(contextvars.copy_context().run, self._localize_batch, batch,
                                                        store, remote_mgr, localize_done)
                                progressed = True
                                continue
                        batch.worker_id = w.worker_id
                        timeout = st.spec.batch_timeout_s
                        batch.dispatched_at = time.monotonic()
                        batch.deadline = batch.dispatched_at + timeout if timeout else None
                        batches[batch.batch_id] = batch
                        st.pool.submit(w, batch.batch_id, batch.refs)
                        if batch.batch_id >= 0:
                            # reconstruction re-runs (negative ids) settle
                            # into their waiters, not into completed/errored
                            st.dispatched += 1
                        progressed = True
                # 4. autoscale (the per-node path re-derives its node
                # budgets from the live agents at every re-plan)
                now = time.monotonic()
                if now - last_autoscale >= cfg.streaming.autoscale_interval_s:
                    self._apply_allocation(states, budget, cfg, remote_mgr=remote_mgr, local_node=node)
                    last_autoscale = now
                    if remote_mgr is not None:
                        for nid, s in remote_mgr.stats().items():
                            self.metrics.set_node_state(nid, s["workers"], s["cpus_used"])
                        # the driver is a node too (the GPU stages live there)
                        driver_workers = sum(st.pool.workers_by_node().get("", 0) for st in states)
                        self.metrics.set_node_state("driver", driver_workers, remote_mgr.local_cpus_used)
                # 5. metrics, live status
                for st in states:
                    ready = len([w for w in st.pool.workers.values() if w.ready])
                    self.metrics.set_pool_state(st.spec.name, ready, st.pool.num_workers() - ready, len(st.in_queue))
                self.metrics.set_store_bytes(store.used)
                self.store_stats["peak_bytes"] = max(self.store_stats["peak_bytes"], store.used)
                if publisher is not None:
                    publisher.maybe_publish(lambda: self._build_live_snapshot(states, batches, store, remote_mgr))
                # 5b. settle the final-output fetches: success frees the
                # batch's held inputs; a failure re-runs the batch (its
                # outputs died with their owner)
                if self._final_fetches:
                    pending = []
                    for stx, fb, f_refs, fut in self._final_fetches:
                        if not fut.done():
                            pending.append((stx, fb, f_refs, fut))
                            continue
                        progressed = True
                        try:
                            outputs.extend(fut.result())
                        except Exception as e:
                            # outputs lost WITH their node charge the
                            # node-death budget, not the poison-batch guard
                            lost = [r.shm_name for r in f_refs if remote_mgr is not None and remote_mgr.owner_dead(r)]
                            _retry_or_drop(stx, fb, store, f"final outputs lost with their owner: {e}",
                                           dead_letter=self._dead_letter, node_death=bool(lost),
                                           lost_node=self._lost_node(lost))
                            continue
                        stx.completed += 1  # settled: the logical batch counts once
                        for r in fb.refs:
                            store.release(r)
                    self._final_fetches = pending
                if (inputs_exhausted and not batches and not localizing and not self._final_fetches
                        and not self._lost_waiters
                        and all(not st.in_queue and not st.retry_queue for st in states)):
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
                    publisher.finalize(self._build_live_snapshot(states, batches, store, remote_mgr))
                except Exception:
                    logger.exception("final live-status publish failed")
            # quiesce the fetch pool FIRST: a running _localize_batch
            # mutates its batch's refs and releases refs itself
            if self._fetch_pool is not None:
                self._fetch_pool.shutdown(wait=True)
            # prefetch-ahead copies nobody adopted (the pool is quiesced, so
            # this drain is final), then the cache itself
            while True:
                try:
                    _pref, local_ref, _perr, _s = prefetch_done.get_nowait()
                except queue.Empty:
                    break
                if local_ref is not None:
                    store.release(local_ref)
            for local_ref in self._prefetched.values():
                store.release(local_ref)
            self._prefetched.clear()
            self._prefetch_inflight.clear()
            for batch in batches.values():  # in flight on an exception exit
                for r in batch.refs:
                    store.release(r)
            while True:
                try:
                    lb, _err = localize_done.get_nowait()
                except queue.Empty:
                    break
                localizing.setdefault(lb.batch_id, lb)
            for batch in localizing.values():
                for r in batch.refs:
                    store.release(r)
            for _stx, fb, _refs, _fut in self._final_fetches:  # inputs held for a fetch
                for r in fb.refs:
                    store.release(r)
            self._final_fetches = []
            # parked batches and unadopted regenerations are in no queue
            for _sidx, wb, _missing in self._lost_waiters.values():
                for r in wb.refs:
                    store.release(r)
            self._lost_waiters.clear()
            for ref in self._renamed.values():
                store.release(ref)
            self._renamed.clear()
            for st in states:
                for r in st.in_queue:
                    store.release(r)
                for batch in st.retry_queue:
                    for r in batch.refs:
                        store.release(r)
                st.pool.shutdown()
                if isinstance(st.pool, ProcessPool):
                    self.worker_pids.update(p for p in st.pool.pids.values() if p is not None)
            if self._tracker is not None:
                # delete every still-deferred lineage input BEFORE the
                # manager's shutdown closes the links its releases ride on
                self._tracker.drain()
            if prewarm is not None:
                self.worker_pids.update(prewarm.pids())
                prewarm.shutdown()
            if remote_mgr is not None:
                self.remote_stats = remote_mgr.stats()
                # the Bye makes each agent flush its final object-plane
                # stats, which shutdown drains: snapshot after it
                remote_mgr.shutdown()
                self.object_plane = object_plane_summaries()
            for st, span in zip(states, stage_spans):
                span.set_attribute("dispatched", st.dispatched)
                span.set_attribute("completed", st.completed)
                span.set_attribute("errored", st.errored_batches)
                tracing.end_span(span)

    # ------------------------------------------------------------------
    def _count_object(self, ref: object_store.ObjectRef) -> None:
        self.store_stats["objects"] += 1
        self.store_stats["bytes_put"] += ref.total_size

    def _start_worker(self, pool: BasePool, node_id: str | None = None) -> None:
        pool.start_worker(node_id=node_id)
        if isinstance(pool, ProcessPool):
            self.worker_pids.update(p for p in pool.pids.values() if p is not None)

    def _build_live_snapshot(self, states, batches, store, remote_mgr=None) -> dict:
        """One live-status snapshot from the loop's own state: per-stage
        queues and worker occupancy, every in-flight batch with its age and
        budgets, the store's bytes in flight, and per-node heartbeat ages."""
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
                        "node_deaths": b.node_deaths,
                        "worker": b.worker_id,
                        "deadline_in_s": round(b.deadline - now, 3) if b.deadline is not None else None,
                    }
                    for b in inflight
                ],
            }
        snap: dict = {"stages": stages, "store_bytes": store.used}
        if remote_mgr is not None:
            snap["nodes"] = remote_mgr.heartbeat_ages()
            if self._recon or self._lost_waiters or self.objects_reconstructed:
                snap["reconstruction"] = {"objects_reconstructed": self.objects_reconstructed,
                                          "re_runs_inflight": len(self._recon),
                                          "parked_waiters": len(self._lost_waiters)}
        return snap

    def _pick_worker(self, idle, refs, remote_mgr, next_pref: str | None = None):
        """The stage-affinity router. First signal: input-byte locality (the
        worker whose node owns the most input bytes moves the least data to
        START the batch). Second: a bonus of half the batch's bytes for the
        NEXT stage's planned node, so without a clear locality winner the
        batch runs where its outputs will be consumed. Inputs already
        prefetched into the driver's store count as the driver's."""
        if remote_mgr is None or len(idle) == 1:
            return idle[0]
        owned_bytes: dict[str, int] = {}
        total = 0
        for r in refs:
            node = "" if r.shm_name in self._prefetched else remote_mgr.owner_node(r)
            owned_bytes[node] = owned_bytes.get(node, 0) + r.total_size
            total += r.total_size
        bonus = total // 2 + 1

        def score(w) -> int:
            node = BasePool.worker_node(w)
            s = owned_bytes.get(node, 0)
            if next_pref is not None and node == next_pref:
                s += bonus
            return s

        return max(idle, key=score)

    def _adopt_prefetched(self, batch: _Batch, store) -> None:
        """Swap a driver-bound batch's prefetched inputs for their cached
        local copies: the remote originals release at their owner and the
        demand localize is skipped (a prefetch HIT)."""
        hits = 0
        for j, r in enumerate(batch.refs):
            local = self._prefetched.pop(r.shm_name, None)
            if local is None:
                continue
            store.release(r)  # routes the delete to the owning agent
            batch.refs[j] = local
            hits += 1
        if hits:
            record_object_plane(prefetch_hits=hits)

    def _maybe_prefetch(self, stage_idx: int, refs, store) -> None:
        """Start moving ``refs`` toward the node the planner gave
        ``stage_idx`` BEFORE any batch is formed: an agent target gets a
        PrefetchObjects push over the control link; a driver target pulls on
        the fetch pool into the local cache. Bounded, deduplicated and
        advisory: a skipped prefetch degrades to the demand pull."""
        remote_mgr = self._remote_mgr
        if remote_mgr is None or self._pref_node is None or not 0 <= stage_idx < len(self._pref_node):
            return
        pref = self._pref_node[stage_idx]
        if len(self._pushed) > 65536:
            # bounded dedup: a pruned entry costs at most one redundant
            # push, which the agent's own cache absorbs
            self._pushed.clear()
        to_push: list = []
        for r in refs:
            if remote_mgr.owner_node(r) == pref:
                continue  # already where the consumer runs
            key = (pref, r.shm_name)
            if key in self._pushed:
                continue
            if pref != "":
                self._pushed.add(key)
                to_push.append(r)  # one control frame for the whole batch
                continue
            if (len(self._prefetch_inflight) >= PREFETCH_INFLIGHT_LIMIT or not store.has_headroom()
                    or r.shm_name in self._prefetched or r.shm_name in self._prefetch_inflight):
                continue
            self._pushed.add(key)
            self._prefetch_inflight.add(r.shm_name)
            self._fetch_pool.submit(contextvars.copy_context().run, self._prefetch_local, r, remote_mgr,
                                    self._prefetch_done)
        if to_push:
            remote_mgr.push_ahead(to_push, pref)

    @staticmethod
    def _prefetch_local(ref, remote_mgr, done_q) -> None:
        """Fetch-pool job: pull one agent-owned segment into the driver's
        store ahead of demand; the loop accounts the completion."""
        t0 = time.monotonic()
        try:
            local = remote_mgr.localize(ref)
            done_q.put((ref, local, None, time.monotonic() - t0))
        except Exception as e:
            done_q.put((ref, None, e, time.monotonic() - t0))

    @staticmethod
    def _localize_batch(batch, store, remote_mgr, done_q) -> None:
        """Fetch-pool job: pull a batch's agent-owned inputs into the
        driver's store (remote workers resolve their own inputs). The batch
        is invisible to dispatch meanwhile, so its refs may change. Each
        pull is a DEMAND fetch: a prefetch miss in the object plane."""
        try:
            for j, r in enumerate(batch.refs):
                if not remote_mgr.owner_node(r):
                    continue
                t0 = time.monotonic()
                local = remote_mgr.localize(r)
                record_object_plane(fetches=1, fetch_bytes=r.total_size, fetch_wait_s=time.monotonic() - t0,
                                    prefetch_misses=1)
                store.account(local)
                store.release(r)  # routes the delete to the owning agent
                batch.refs[j] = local
            done_q.put((batch, None))
        except Exception as e:
            done_q.put((batch, e))

    @staticmethod
    def _fetch_final_values(refs, remote_mgr) -> list:
        """Fetch-pool job: materialize one batch's remote final outputs and
        release them at their owner. All or nothing: a failure raises, so
        the loop re-runs the whole batch (a partial list would duplicate
        the fetched outputs on the re-run)."""
        values = []
        err: Exception | None = None
        for r in refs:
            try:
                if err is None:
                    t0 = time.monotonic()
                    values.append(remote_mgr.fetch_value_if_remote(r))
                    record_object_plane(fetches=1, fetch_bytes=r.total_size, fetch_wait_s=time.monotonic() - t0)
            except Exception as e:  # keep releasing the rest
                err = e
            finally:
                remote_mgr.release_data(r)
        if err is not None:
            raise err
        return values

    def _free_ref(self, ref) -> None:
        """Location-aware delete of a ref OUTSIDE the ledger (final outputs,
        late results)."""
        if self._remote_mgr is not None:
            self._remote_mgr.release_data(ref)
        else:
            object_store.delete(ref)

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
                self._free_ref(r)
            return
        st = states[batch.stage_idx]
        w = st.pool.workers.get(msg.worker_id)
        if w is not None:
            w.busy_batch = None
            w.batches_done += 1
        if batch.batch_id in self._recon:
            # a reconstruction re-run: its outputs replace lost refs in
            # place instead of feeding the next stage's queue
            self._handle_recon_result(states, batch, msg, store)
            return
        if msg.error is not None:
            if self._remote_mgr is not None:
                if any(self._remote_mgr.owner_dead(r) for r in batch.refs):
                    # the batch failed FETCHING inputs whose owner died, not
                    # running user code: reconstruct through lineage (or
                    # charge the node-death budget), never the retries
                    self._on_lost_or_failed_inputs(states, st, batch, store,
                                                   f"inputs lost to a dead node: {_tail(msg.error, 400)}")
                    return
                if msg.input_loss:
                    # the fetch failed without a provably dead owner (a
                    # transient drop, a racing release): the infra budget
                    _retry_or_drop(st, batch, store, f"input fetch failed: {_tail(msg.error, 400)}",
                                   dead_letter=self._dead_letter)
                    return
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
        # throughput samples count per EXECUTION, per node; st.completed
        # counts logical batches (deferred to the fetch's settlement when
        # remote final outputs are pending)
        st.pool.record_sample(msg.process_time_s, node_id=BasePool.worker_node(w) if w is not None else "")
        self._stage_durs[batch.stage_idx].append(msg.process_time_s)
        self.stage_times[st.spec.name] = self.stage_times.get(st.spec.name, 0.0) + msg.process_time_s
        self.metrics.observe_result(st.spec.name, msg.process_time_s, len(msg.out_refs), msg.deserialize_time_s)
        nxt = batch.stage_idx + 1
        final_remote: list = []
        forward: list = []
        for r in msg.out_refs:
            self._count_object(r)
            if nxt < len(states):
                store.account(r)  # the queue bounds and input gating hold back
                states[nxt].in_queue.append(r)
                forward.append(r)
                continue
            # final outputs stay out of the ledger: they are freed here, and
            # accounting them would pin ``used`` and stall the seeding.
            # Agent-owned ones stream in on the fetch pool, never this loop
            if self._remote_mgr is not None and self._remote_mgr.owner_node(r):
                if cfg.return_last_stage_outputs:
                    final_remote.append(r)
                else:
                    self._free_ref(r)
                continue
            if cfg.return_last_stage_outputs:
                outputs.append(object_store.get(r))
            object_store.delete(r)
        if forward:
            if self._tracker is not None:
                # lineage: these outputs are re-derivable from this batch's
                # inputs at this stage; the inputs' physical delete defers
                # until every output releases
                self._tracker.record(batch.stage_idx, list(batch.refs), forward)
            # push-ahead: move the outputs toward the next stage's planned
            # node while this loop goes on
            self._maybe_prefetch(nxt, forward, store)
        if final_remote:
            # the batch's INPUTS stay held until its remote outputs are
            # fetched: if their agent dies first, the batch re-runs
            self._final_fetches.append((st, batch, final_remote,
                                        self._fetch_pool.submit(contextvars.copy_context().run,
                                                                self._fetch_final_values, final_remote,
                                                                self._remote_mgr)))
            return
        st.completed += 1
        for r in batch.refs:
            store.release(r)

    _MAX_SETUP_DEATHS = 3

    def _expire_hung_batches(self, states, batches) -> bool:
        """A batch past its ``batch_timeout_s`` means its worker is presumed
        hung: the worker is killed, and the dead-worker reap re-queues the
        batch under its worker-death budget. Local process workers only: an
        agent's watchdog kills a remote one, and a device stage's thread
        cannot be killed."""
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
            if getattr(w.proc, "_agent", None) is not None:
                continue  # the agent's watchdog owns remote deadlines
            logger.warning("stage %s batch %d exceeded batch_timeout_s=%.1fs; killing hung worker %s",
                           st.spec.name, batch.batch_id, timeout, w.worker_id)
            self.metrics.observe_error(st.spec.name)
            try:
                w.proc.kill()  # SIGKILL: a hung worker may ignore SIGTERM
            except (OSError, AttributeError):
                logger.debug("kill failed for %s", w.worker_id, exc_info=True)
            progressed = True
        return progressed

    def _dead_letter(self, stx, batch: _Batch, *, reason: str, error: str = "", lost_node: str = "",
                     lineage=None) -> None:
        """Persist a dropped batch's payloads and metadata. Runs BEFORE the
        refs are released; never raises (a DLQ failure degrades to a
        log-only drop). An owner-loss drop stamps ``lost_node`` and the
        lineage chain reconstruction gave up on."""
        dlq = self.dlq
        if dlq is None or not dlq.enabled:
            return
        fetch = self._remote_mgr.fetch_value_if_remote if self._remote_mgr is not None else object_store.get
        tasks, errs = [], []
        for r in batch.refs:
            try:
                tasks.append(fetch(r))
            except Exception as e:  # a partial entry beats none
                errs.append(f"{r.shm_name}: {e}")
        if dlq.record(stage_name=stx.spec.name, batch_id=batch.batch_id, tasks=tasks, attempts=batch.attempts,
                      worker_deaths=batch.worker_deaths, reason=reason, error=error, payload_errors=errs or None,
                      lost_node=lost_node, node_deaths=batch.node_deaths, lineage=lineage):
            stx.dead_lettered += 1

    # -- lineage-based reconstruction ----------------------------------
    def _adopt_renamed(self, batch: _Batch, store) -> int:
        """Swap in inputs an earlier reconstruction already regenerated: the
        lost name leaves the ledger and the regenerated ref takes its place."""
        n = 0
        for j, r in enumerate(batch.refs):
            new = self._renamed.pop(r.shm_name, None)
            if new is None:
                continue
            store.release(r)
            batch.refs[j] = new
            n += 1
        return n

    def _on_lost_or_failed_inputs(self, states, stx, batch: _Batch, store, reason: str) -> None:
        """A batch whose input fetch failed: reconstruct lost inputs through
        lineage where possible; else charge the node-death budget (the
        owner is provably dead) or the infra budget (a transient failure),
        dead-lettering with the lost node and lineage chain when it is
        spent."""
        mgr = self._remote_mgr
        if mgr is not None and self._tracker is not None:
            self._adopt_renamed(batch, store)
            missing = {r.shm_name for r in batch.refs if mgr.owner_dead(r)}
            if missing:
                if self._schedule_reconstruction(states, batch, missing, store):
                    logger.warning("stage %s batch %d: reconstructing %d lost input(s) via lineage (%s)",
                                   stx.spec.name, batch.batch_id, len(missing), reason)
                    return
                _retry_or_drop(stx, batch, store, reason, dead_letter=self._dead_letter, node_death=True,
                               lost_node=self._lost_node(missing), lineage=self._chain_for(missing))
                return
        _retry_or_drop(stx, batch, store, reason, dead_letter=self._dead_letter)

    def _schedule_reconstruction(self, states, batch: _Batch, missing: set, store, depth: int = 0) -> bool:
        """Re-enqueue the producing batch of every name in ``missing`` at
        its stage (once per record; recursively when the producer's own
        inputs died too, up to the depth, charging the run's budget);
        ``batch`` parks off every queue until its inputs re-materialize.
        False when lineage, depth or budget cannot cover the loss.

        Plan, then commit: the whole transitive producer set is checked
        before any record is marked in flight, or a half-registered plan
        would leave waiters parked forever."""
        tracker = self._tracker
        if tracker is None:
            return False
        to_run: dict[int, tuple] = {}  # id(rec) -> (rec, its own lost inputs)
        frontier = set(missing)
        d = depth
        while frontier:
            if d > self._recon_depth:
                return False
            next_frontier: set = set()
            for name in frontier:
                rec = tracker.producer(name)
                if rec is None:
                    return False  # lineage gone (outputs released): no way back
                if id(rec) in to_run or rec.inflight_batch is not None:
                    continue  # planned already, or re-running already
                producer_missing = {r.shm_name for r in rec.input_refs
                                    if r.shm_name not in self._renamed and self._remote_mgr.owner_dead(r)}
                to_run[id(rec)] = (rec, producer_missing)
                next_frontier |= producer_missing
            frontier = next_frontier
            d += 1
        if self._recon_spent + len(to_run) > self._recon_budget:
            logger.error("reconstruction budget exhausted (%d/%d producer re-runs): giving up on batch %d",
                         self._recon_spent, self._recon_budget, batch.batch_id)
            return False
        self._recon_spent += len(to_run)
        for rec, producer_missing in to_run.values():
            self._recon_seq -= 1  # negative ids never collide with dispatch's
            rb = _Batch(self._recon_seq, rec.stage_idx, list(rec.input_refs))
            rec.inflight_batch = rb.batch_id
            self._recon[rb.batch_id] = rec
            self._recon_started[rb.batch_id] = time.monotonic()
            self._adopt_renamed(rb, store)
            if producer_missing:
                self._park_waiter(rb, producer_missing)
            else:
                states[rec.stage_idx].retry_queue.appendleft(rb)
        self._park_waiter(batch, missing)
        return True

    def _park_waiter(self, batch: _Batch, missing: set) -> None:
        batch.deadline = None
        parked = self._lost_waiters.get(batch.batch_id)
        if parked is not None:
            parked[2].update(missing)
        else:
            self._lost_waiters[batch.batch_id] = (batch.stage_idx, batch, set(missing))

    def _handle_recon_result(self, states, batch: _Batch, msg, store) -> None:
        """Settle a reconstruction re-run: regenerated outputs replace the
        lost refs in place in every parked waiter (same items out, new
        segment names); a waiter whose missing set empties re-enters
        dispatch. Unclaimed regenerations park in the rename map, where an
        in-flight batch dispatched before the node died adopts them."""
        rec = self._recon.get(batch.batch_id)
        st = states[batch.stage_idx]
        if msg.error is not None:
            self.metrics.observe_error(st.spec.name)
            if self._remote_mgr is not None:
                self._adopt_renamed(batch, store)
                deeper = {r.shm_name for r in batch.refs if self._remote_mgr.owner_dead(r)}
                if deeper and self._schedule_reconstruction(states, batch, deeper, store):
                    return
            batch.attempts += 1
            if batch.attempts < max(1, st.spec.num_run_attempts) + 1:
                st.retry_queue.appendleft(batch)
                return
            self._fail_reconstruction(states, rec, batch, store, f"re-execution failed: {_tail(msg.error, 400)}")
            return
        self._recon.pop(batch.batch_id, None)
        started = self._recon_started.pop(batch.batch_id, None)
        dur = time.monotonic() - started if started is not None else 0.0
        rec.inflight_batch = None
        new_outs = list(msg.out_refs)
        # re-record lineage FIRST, from the inputs that actually made these
        # outputs: the new record's holds must exist before an old ref
        # releases below, or a SECOND node loss would drop data
        positional = new_outs[: len(rec.out_names)]
        if positional and self._tracker is not None:
            self._tracker.record(rec.stage_idx, list(batch.refs), positional)
        adopted = 0
        for i, old in enumerate(rec.out_names):
            new_ref = new_outs[i] if i < len(new_outs) else None
            waiter = self._waiter_for(old)
            if waiter is not None:
                wid, sidx, wb, miss = waiter
                if new_ref is None:
                    # the re-run gave fewer outputs than the original: this
                    # waiter is lost
                    del self._lost_waiters[wid]
                    self._fail_waiter(states, sidx, wb, store, f"reconstruction produced no output for {old}")
                    continue
                for j, r in enumerate(wb.refs):
                    if r.shm_name == old:
                        store.release(r)  # retire the lost ref
                        wb.refs[j] = new_ref
                store.account(new_ref)
                adopted += 1
                miss.discard(old)
                if not miss:
                    del self._lost_waiters[wid]
                    states[sidx].retry_queue.appendleft(wb)
                continue
            if new_ref is None:
                continue
            if old in rec.live:
                # the old name is still referenced (a queued input, an
                # in-flight batch): park the regeneration for adoption
                self._renamed[old] = new_ref
                store.account(new_ref)
                adopted += 1
            elif self._tracker is None or self._tracker.release(new_ref):
                # nobody references this output any more
                self._free_ref(new_ref)
        for extra in new_outs[len(rec.out_names):]:
            self._free_ref(extra)
        # inputs this re-run ADOPTED from earlier reconstructions were
        # accounted at adoption, and re-runs settle here, never through the
        # completion path that releases inputs
        for r in batch.refs:
            if store.tracks(r):
                store.release(r)
        self.objects_reconstructed += adopted
        self.reconstruction_seconds += dur
        if adopted:
            self.metrics.observe_reconstruction(st.spec.name, adopted, dur)
            logger.info("reconstructed %d object(s) at stage %s in %.2fs", adopted, st.spec.name, dur)

    def _retry_recon_or_fail(self, states, batch: _Batch, store, reason: str) -> None:
        """An infra failure of a reconstruction re-run: re-queue it under the
        node-death budget (never the DLQ: its payloads belong to the
        waiters), cascading a give-up to every waiter."""
        batch.node_deaths += 1
        if batch.node_deaths <= MAX_NODE_DEATHS_PER_BATCH:
            states[batch.stage_idx].retry_queue.appendleft(batch)
            return
        self._fail_reconstruction(states, self._recon.get(batch.batch_id), batch, store, reason)

    def _waiter_for(self, name: str):
        for wid, (sidx, wb, miss) in self._lost_waiters.items():
            if name in miss:
                return wid, sidx, wb, miss
        return None

    def _fail_waiter(self, states, sidx: int, wb: _Batch, store, reason: str, lost_node: str = "",
                     chain=None) -> None:
        if wb.batch_id in self._recon:
            # a re-run that waited on a deeper reconstruction: cascade
            self._fail_reconstruction(states, self._recon[wb.batch_id], wb, store, reason)
            return
        stx = states[sidx]
        stx.errored_batches += 1
        logger.error("batch %d dropped: %s (%d tasks lost)", wb.batch_id, reason, len(wb.refs))
        self._dead_letter(stx, wb, reason=reason, lost_node=lost_node, lineage=chain)
        for r in wb.refs:
            store.release(r)

    def _fail_reconstruction(self, states, rec, batch: _Batch, store, reason: str) -> None:
        """A reconstruction re-run is gone for good: every batch waiting on
        its record's outputs drops to the DLQ with the lost node and the
        lineage chain."""
        self._recon.pop(batch.batch_id, None)
        self._recon_started.pop(batch.batch_id, None)
        if rec is not None:
            rec.inflight_batch = None
        for r in batch.refs:
            if store.tracks(r):
                store.release(r)
        names = set(rec.out_names) if rec is not None else set()
        lost_node = self._lost_node(names)
        for wid, (sidx, wb, miss) in list(self._lost_waiters.items()):
            hit = miss & names
            if not hit:
                continue
            del self._lost_waiters[wid]
            self._fail_waiter(states, sidx, wb, store, f"reconstruction gave up: {reason}", lost_node=lost_node,
                              chain=self._chain_for(hit))

    def _lost_node(self, names) -> str:
        """The dead node that owned the first resolvable lost name (the
        DLQ's ``lost_node``)."""
        mgr = self._remote_mgr
        if mgr is None:
            return ""
        for n in names:
            node = mgr.node_of(n)
            if node:
                return node
        return ""

    def _chain_for(self, names) -> list | None:
        if self._tracker is None:
            return None
        chain: list = []
        for n in list(names)[:4]:  # bounded: DLQ metadata, not a dump
            chain.extend(self._tracker.chain(n, self._stage_names))
        return chain or None

    def _reap_dead_workers(self, states, batches, store) -> bool:
        progressed = False
        for st in states:
            if not isinstance(st.pool, ProcessPool):
                continue
            for w in list(st.pool.workers.values()):
                proc = w.proc
                if proc is None or proc.is_alive():
                    continue
                exitcode = getattr(proc, "exitcode", "remote")
                logger.warning("worker %s died (exit %s)", w.worker_id, exitcode)
                st.pool.workers.pop(w.worker_id, None)
                st.pool.note_worker_gone(w)
                agent = getattr(proc, "_agent", None)
                if not w.ready and (agent is None or agent.alive):
                    # died before it was ready with its NODE alive: likely a
                    # setup crash; the cap stops a respawn loop when setup
                    # always fails (a whole-agent death is node churn)
                    st.pool.setup_deaths += 1
                    if st.pool.setup_deaths >= self._MAX_SETUP_DEATHS:
                        raise RuntimeError(f"stage {st.spec.name}: {st.pool.setup_deaths} workers died during "
                                           f"setup (last exit {exitcode}); aborting pipeline")
                if w.busy_batch is not None and w.busy_batch in batches:
                    batch = batches.pop(w.busy_batch)
                    if batch.batch_id in self._recon:
                        self._retry_recon_or_fail(states, batch, store, f"worker {w.worker_id} died re-running it")
                    elif agent is not None and not agent.alive:
                        # lost WITH its node: the node-death budget
                        _retry_or_drop(st, batch, store, f"its node {agent.node_id} died mid-batch",
                                       dead_letter=self._dead_letter, node_death=True, lost_node=agent.node_id)
                    else:
                        _retry_or_drop(st, batch, store, f"worker {w.worker_id} died processing it (poison batch?)",
                                       dead_letter=self._dead_letter)
                # the replacement goes on the dead worker's node; placement
                # falls back to the least loaded when that node died too
                self._start_worker(st.pool, node_id=st.pool.worker_node(w) if self._remote_mgr else None)
                progressed = True
        return progressed

    def _apply_allocation(self, states, budget: Budget, cfg, remote_mgr=None, local_node=None) -> None:
        window = cfg.streaming.speed_estimation_window_s
        scale_states = [
            StageScaleState(spec=st.spec, throughput_per_worker=st.pool.throughput_per_worker(window),
                            queued=len(st.in_queue), node_rates=st.pool.node_throughputs(window))
            for st in states
        ]
        if remote_mgr is None:
            targets = plan_allocation(scale_states, budget)
            self._pref_node = [""] * len(states)
            for st, target in zip(states, targets):
                cur = st.pool.num_workers()
                for _ in range(max(0, target - cur)):
                    self._start_worker(st.pool)
                if target < cur:
                    for w in st.pool.idle_workers()[: cur - target]:  # idle workers only
                        st.pool.stop_worker(w)
            return
        # cross-host: one NodeBudget per live host, re-derived every re-plan,
        # so a dead agent drops out of the plan and a late joiner enters it
        nodes = [NodeBudget("", cpus=local_node.num_cpus if local_node is not None else budget.cpus,
                            gpus=local_node.num_gpus if local_node is not None else 0,
                            memory_gb=_host_memory_bytes() / (1 << 30))]
        nodes += [NodeBudget(nid, cpus=cpus, memory_gb=mem) for nid, cpus, mem in remote_mgr.node_budgets()]
        plan = plan_node_allocation(scale_states, nodes)
        self._pref_node = plan.preferred_node
        self.node_plan = {st.spec.name: dict(pn) for st, pn in zip(states, plan.per_node)}
        for st, counts in zip(states, plan.per_node):
            cur = st.pool.workers_by_node()
            for nid, want in counts.items():
                for _ in range(max(0, want - cur.get(nid, 0))):
                    self._start_worker(st.pool, node_id=nid)
            # idle workers on a node over its target go (a node absent from
            # the plan has target 0)
            for nid, have in cur.items():
                want = counts.get(nid, 0)
                if have <= want:
                    continue
                surplus = [w for w in st.pool.idle_workers() if st.pool.worker_node(w) == nid]
                for w in surplus[: have - want]:
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


def _retry_or_drop(stx, batch: _Batch, store, reason: str, *, dead_letter=None, node_death=False, lost_node="",
                   lineage=None) -> None:
    """An infra failure (a worker death, a failed localize or final fetch):
    re-queue the batch under its worker-death cap, or with ``node_death``
    under the separate node-death cap; else drop it loudly, dead-lettering
    it (with the lost node and lineage chain of an owner loss) before its
    refs are released."""
    if node_death:
        batch.node_deaths += 1
        count, cap, kind = batch.node_deaths, MAX_NODE_DEATHS_PER_BATCH, "node deaths"
    else:
        batch.worker_deaths += 1
        count, cap, kind = batch.worker_deaths, MAX_WORKER_DEATHS_PER_BATCH, "infra failures"
    if count <= cap:
        logger.warning("batch %d: %s; re-running (%d/%d %s)", batch.batch_id, reason, count, cap, kind)
        stx.retry_queue.append(batch)
        return
    logger.error("batch %d dropped after %d %s (%s): %d tasks lost", batch.batch_id, count, kind, reason,
                 len(batch.refs))
    stx.errored_batches += 1
    if dead_letter is not None:
        dead_letter(stx, batch, reason=reason, lost_node=lost_node, lineage=lineage)
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
