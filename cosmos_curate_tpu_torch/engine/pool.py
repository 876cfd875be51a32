"""Per-stage worker pools of the streaming engine (port of
``cosmos_curate_tpu/engine/pool.py``, its single-host part).

Two pool kinds behind one interface:

- ``ProcessPool``: CPU stages, in spawned worker processes
  (engine/worker.py) with a control queue each and one result queue shared
  by every pool's processes;
- ``InProcessPool``: GPU stages (``Resources.uses_gpu``), in one thread of
  the engine's own process, which owns the host's cards. Batch size, not
  worker count, scales a device stage.

Both take and give ``ObjectRef``s, so the orchestration loop has one data
path. ``PrewarmPool`` keeps generic worker processes spawned ahead of need.

A CPU worker runs with ``CUDA_VISIBLE_DEVICES=""`` (``_base_worker_env``,
where the reference sets ``JAX_PLATFORMS=cpu``): it never creates a CUDA
context, which would take device memory from the device stages. A device
stage's thread sets no current device: the stage places its tensors on its
own device and the kernel wrappers enter ``torch.cuda.device`` themselves.

With the cross-node plane (engine/remote_plane.py) a ``ProcessPool`` may
place a worker on a connected node agent (``remote_mgr``): the handle's
``proc`` is then the plane's stand-in, which carries the agent (``_agent``),
and ``worker_node`` names that agent's node ('' for the driver).
``start_worker(node_id=...)`` takes the per-node planner's placement, and
``node_throughputs`` gives the planner each node's measured rate. The
driver's ``CURATE_CHAOS`` plan rides every worker's environment.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing as mp
import os
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any

import cloudpickle

from cosmos_curate_tpu_torch import chaos

from cosmos_curate_tpu_torch.core.stage import NodeInfo, StageSpec, WorkerMetadata
from cosmos_curate_tpu_torch.engine import object_store
from cosmos_curate_tpu_torch.engine.worker import (
    ProcessMsg,
    ReadyMsg,
    ResultMsg,
    SetupMsg,
    ShutdownMsg,
    _fetch_batch,
    worker_main,
)
from cosmos_curate_tpu_torch.observability.tracing import (
    TRACEPARENT_ENV,
    TRACING_ENV,
    format_traceparent,
    traced_span,
    tracing_enabled,
)
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_MP = mp.get_context("spawn")


@dataclass
class WorkerHandle:
    worker_id: str
    in_q: object
    proc: object | None = None  # the mp.Process of a ProcessPool worker
    ready: bool = False
    busy_batch: int | None = None
    started_at: float = field(default_factory=time.monotonic)
    batches_done: int = 0


class BasePool:
    """Bookkeeping both pool kinds share. ``pool_id`` (the stage's index)
    namespaces worker ids: one stage class may sit at several positions,
    and results route by worker id."""

    def __init__(self, spec: StageSpec, node: NodeInfo, pool_id: int = 0) -> None:
        self.spec = spec
        self.pool_id = pool_id
        self.stage = spec.stage
        self.node = node
        self.workers: dict[str, WorkerHandle] = {}
        # traceparent of the driver's stage span that submitted batches
        # parent onto ('' = tracing off)
        self.trace_context: str = ""
        self._next_id = 0
        # recent (finish time, process seconds, node id) samples for the
        # autoscaler; node '' = a worker placed on the driver
        self.samples: list[tuple[float, float, str]] = []
        # workers told to shut down, awaiting reap (never blocks the loop)
        self.draining: list[tuple[WorkerHandle, float]] = []
        # workers that died before they were ever ready
        self.setup_deaths: int = 0

    @property
    def name(self) -> str:
        return self.spec.name

    def idle_workers(self) -> list[WorkerHandle]:
        return [w for w in self.workers.values() if w.ready and w.busy_batch is None]

    def num_workers(self) -> int:
        return len(self.workers)

    @property
    def workers_started(self) -> int:
        """Every worker this pool has started, replacements included."""
        return self._next_id

    @staticmethod
    def worker_node(w: WorkerHandle) -> str:
        """'' for a worker placed on the driver, else its agent's node id."""
        agent = getattr(w.proc, "_agent", None)
        return agent.node_id if agent is not None else ""

    def workers_by_node(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for w in self.workers.values():
            node = self.worker_node(w)
            counts[node] = counts.get(node, 0) + 1
        return counts

    def record_sample(self, process_time_s: float, node_id: str = "") -> None:
        now = time.monotonic()
        self.samples.append((now, process_time_s, node_id))
        cutoff = now - 600.0
        while self.samples and self.samples[0][0] < cutoff:
            self.samples.pop(0)

    def throughput_per_worker(self, window_s: float) -> float | None:
        """Batches a second one worker achieves, from recent samples."""
        now = time.monotonic()
        recent = [p for (t, p, _n) in self.samples if t >= now - window_s]
        if not recent:
            return None
        mean_t = sum(recent) / len(recent)
        return 1.0 / mean_t if mean_t > 0 else None

    def node_throughputs(self, window_s: float) -> dict[str, float]:
        """Per-node batches a second one worker achieves: the per-node
        planner biases CPU fan-out toward nodes that measurably process
        this stage faster."""
        now = time.monotonic()
        by_node: dict[str, list[float]] = {}
        for t, p, node in self.samples:
            if t >= now - window_s:
                by_node.setdefault(node, []).append(p)
        out: dict[str, float] = {}
        for node, ps in by_node.items():
            mean_t = sum(ps) / len(ps)
            if mean_t > 0:
                out[node] = 1.0 / mean_t
        return out

    def lifetime_expired(self, w: WorkerHandle) -> bool:
        lim = self.spec.worker_max_lifetime_m or 0
        return lim > 0 and (time.monotonic() - w.started_at) > lim * 60

    # ``node_id`` is the per-node planner's placement: None = least-loaded
    # placement, '' = the driver, else that agent (falling back when it died
    # since the plan)
    def start_worker(self, node_id: str | None = None) -> WorkerHandle:  # pragma: no cover - abstract
        raise NotImplementedError

    def stop_worker(self, w: WorkerHandle) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def note_worker_gone(self, w: WorkerHandle) -> None:
        """The runner reaped a DEAD worker (``stop_worker`` never ran):
        release its placement accounting."""

    def submit(self, w: WorkerHandle, batch_id: int, refs: list) -> None:
        w.busy_batch = batch_id
        w.in_q.put(ProcessMsg(batch_id=batch_id, refs=refs, timeout_s=self.spec.batch_timeout_s or 0.0,
                              traceparent=self.trace_context))

    def reap_draining(self, *, force_after_s: float = 5.0) -> None:
        """Non-blocking cleanup of workers told to stop."""
        still = []
        now = time.monotonic()
        for w, since in self.draining:
            proc = w.proc
            if proc is None or not proc.is_alive():
                if proc is not None:
                    proc.join(timeout=0)
                continue
            if now - since > force_after_s:
                proc.terminate()
                continue
            still.append((w, since))
        self.draining = still

    def shutdown(self) -> None:
        for w in list(self.workers.values()):
            self.stop_worker(w)
        # the final shutdown may block briefly; it is off the loop's path
        deadline = time.monotonic() + 5.0
        for w, _ in self.draining:
            proc = w.proc
            if proc is None:
                continue
            proc.join(timeout=max(0.0, deadline - time.monotonic()))
            if proc.is_alive():
                proc.terminate()
        self.draining.clear()


def _base_worker_env() -> dict[str, str]:
    env = {
        "CUDA_VISIBLE_DEVICES": "",  # a CPU worker never claims a card
        "OPENCV_FFMPEG_LOGLEVEL": "-8",
        # segments a worker creates belong to this coordinator (see
        # object_store.put): recycled workers leave live data behind
        "CURATE_STORE_OWNER": os.environ.get("CURATE_STORE_OWNER", str(os.getpid())),
    }
    if tracing_enabled() or os.environ.get(TRACING_ENV) == "1":
        env[TRACING_ENV] = "1"
        # the driver's ambient span (the run root, when workers start from
        # the loop) becomes the worker's process-level parent
        tp = format_traceparent() or os.environ.get(TRACEPARENT_ENV, "")
        if tp:
            env[TRACEPARENT_ENV] = tp
    if os.environ.get(chaos.CHAOS_ENV):
        # fault plans follow workers: the worker-batch sites fire there
        env[chaos.CHAOS_ENV] = os.environ[chaos.CHAOS_ENV]
    return env


class PrewarmPool:
    """Warm spares: generic worker processes spawned ahead of need.

    A worker is stage-agnostic until its ``SetupMsg``, so a cold start's
    costly part (the spawn and its imports) can be paid early: scaling up
    adopts a spare and pays only the stage's setup, and a replacement spare
    is spawned in the background after each adoption."""

    def __init__(self, results_q, size: int = 0) -> None:
        self.results_q = results_q
        self.size = size
        self._spares: list[tuple[Any, Any]] = []  # (in_q, proc)
        self._lock = threading.Lock()
        self._closed = False
        for _ in range(size):
            self._spawn()

    def pids(self) -> list[int]:
        with self._lock:
            return [proc.pid for _, proc in self._spares if proc.pid is not None]

    def _spawn(self) -> None:
        with self._lock:
            if self._closed:
                return
        in_q = _MP.Queue()
        env = dict(_base_worker_env(), CURATE_WORKER_ID="prewarm-spare")
        proc = _MP.Process(target=worker_main, args=(in_q, self.results_q, env), daemon=True, name="prewarm-spare")
        proc.start()
        with self._lock:
            if self._closed:  # shutdown raced the spawn: stop the newborn
                try:
                    in_q.put(ShutdownMsg())
                except Exception:
                    proc.terminate()
                return
            self._spares.append((in_q, proc))

    def take(self):
        """(in_q, proc) of a live spare, or None. Replenishes in the
        background, one replacement per spare popped."""
        replacements = 0
        taken = None
        with self._lock:
            while self._spares and taken is None:
                in_q, proc = self._spares.pop()
                replacements += 1
                if proc.is_alive():
                    taken = (in_q, proc)
                else:
                    proc.join(timeout=0)  # reap the dead spare
        for _ in range(replacements):
            threading.Thread(target=self._spawn, daemon=True).start()
        return taken

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
            spares, self._spares = self._spares, []
        for in_q, proc in spares:
            try:
                in_q.put(ShutdownMsg())
            except Exception:
                proc.terminate()
        for _, proc in spares:
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.terminate()


class ProcessPool(BasePool):
    def __init__(self, spec: StageSpec, node: NodeInfo, results_q, pool_id: int = 0,
                 prewarm: PrewarmPool | None = None, remote_mgr=None) -> None:
        super().__init__(spec, node, pool_id)
        self.results_q = results_q  # mp queue shared by every pool's processes
        self.prewarm = prewarm
        self._stage_pickle = cloudpickle.dumps(spec.stage)
        # every worker process this pool started or adopted, by worker id
        # (local processes only: a remote worker's pid is its agent's)
        self.pids: dict[str, int] = {}
        # the cross-node plane: when set, start_worker may place a worker on
        # a connected node agent once the driver's CPUs fill
        self.remote_mgr = remote_mgr

    @property
    def _cpu_cost(self) -> float:
        return self.stage.resources.cpus

    def start_worker(self, node_id: str | None = None) -> WorkerHandle:
        wid = f"s{self.pool_id}-{self.name}-p{self._next_id}"
        self._next_id += 1
        env = dict(_base_worker_env(), CURATE_WORKER_ID=wid)
        if self.remote_mgr is None:
            agent = None
        elif node_id is None:
            agent = self.remote_mgr.place(self._cpu_cost)
        else:
            agent = self.remote_mgr.place_for(node_id, self._cpu_cost)
        if agent is not None:
            meta = WorkerMetadata(worker_id=wid, stage_name=self.name,
                                  node=NodeInfo(node_id=agent.node_id, num_cpus=agent.num_cpus, num_gpus=0),
                                  allocation=self.stage.resources)
            in_q, proc = self.remote_mgr.start_remote_worker(agent, wid, self._stage_pickle, cloudpickle.dumps(meta),
                                                             env, cpu_cost=self._cpu_cost)
            handle = WorkerHandle(worker_id=wid, in_q=in_q, proc=proc)
            self.workers[wid] = handle
            return handle
        adopted = self.prewarm.take() if self.prewarm is not None else None
        if adopted is not None:
            in_q, proc = adopted
            setup_env = env  # the worker applies it before loading the stage
        else:
            in_q = _MP.Queue()
            proc = _MP.Process(target=worker_main, args=(in_q, self.results_q, env), daemon=True, name=wid)
            proc.start()
            setup_env = None
        meta = WorkerMetadata(worker_id=wid, stage_name=self.name, node=self.node, allocation=self.stage.resources)
        in_q.put(SetupMsg(self._stage_pickle, cloudpickle.dumps(meta), env=setup_env))
        handle = WorkerHandle(worker_id=wid, in_q=in_q, proc=proc)
        self.workers[wid] = handle
        self.pids[wid] = proc.pid
        if self.remote_mgr is not None:
            self.remote_mgr.note_local_start(self._cpu_cost)
        return handle

    def stop_worker(self, w: WorkerHandle) -> None:
        """Ask the worker to shut down; never blocks (``reap_draining``
        finishes the job)."""
        try:
            w.in_q.put(ShutdownMsg())
        except Exception:
            pass
        self.workers.pop(w.worker_id, None)
        if self.remote_mgr is not None and not hasattr(w.proc, "_agent"):
            # a driver-placed worker (a remote one's cost is released on the
            # manager's StopWorker path)
            self.remote_mgr.note_local_stop(self._cpu_cost)
        if w.proc is not None:
            self.draining.append((w, time.monotonic()))

    def note_worker_gone(self, w: WorkerHandle) -> None:
        if self.remote_mgr is None:
            return
        if hasattr(w.proc, "_agent"):
            self.remote_mgr.note_remote_gone(w.proc)
        else:
            self.remote_mgr.note_local_stop(self._cpu_cost)


class InProcessPool(BasePool):
    """GPU stages: one worker thread in the engine's process."""

    # how long shutdown waits for the worker thread's destroy
    DESTROY_WAIT_S = 60.0

    def __init__(self, spec: StageSpec, node: NodeInfo, results_q: queue.Queue, pool_id: int = 0) -> None:
        super().__init__(spec, node, pool_id)
        self.results_q = results_q
        self._lock = threading.Lock()  # a device stage runs one batch at a time
        self._threads: list[threading.Thread] = []

    def start_worker(self, node_id: str | None = None) -> WorkerHandle:  # noqa: ARG002 - always the driver
        if self.workers:
            # threads would share the one stage instance (double setup,
            # destroy while in use)
            raise RuntimeError(f"GPU stage {self.name} supports exactly one in-process worker; "
                               "scale it by batch size, not worker count")
        wid = f"s{self.pool_id}-{self.name}-t{self._next_id}"
        self._next_id += 1
        handle = WorkerHandle(worker_id=wid, in_q=queue.Queue())
        self.workers[wid] = handle
        thread = threading.Thread(target=self._thread_main, args=(handle,), daemon=True, name=wid)
        thread.start()
        self._threads.append(thread)
        return handle

    def _thread_main(self, handle: WorkerHandle) -> None:
        stage = self.stage
        meta = WorkerMetadata(worker_id=handle.worker_id, stage_name=self.name, node=self.node,
                              allocation=stage.resources)
        # the same bounded concurrent input fetch the spawned workers use
        fetch_pool = concurrent.futures.ThreadPoolExecutor(max_workers=4,
                                                           thread_name_prefix=f"{handle.worker_id}-fetch")
        try:
            with self._lock:
                stage.setup_on_node(self.node, meta)
                stage.setup(meta)
            self.results_q.put(ReadyMsg(worker_id=handle.worker_id))
        except Exception:
            self.results_q.put(ReadyMsg(worker_id=handle.worker_id, error=traceback.format_exc()))
            fetch_pool.shutdown(wait=False)
            return
        while True:
            msg = handle.in_q.get()
            if isinstance(msg, ShutdownMsg):
                break
            t0 = time.monotonic()
            try:
                tasks = _fetch_batch(msg.refs, fetch_pool)
                dt = time.monotonic() - t0
                # the span opens outside the lock: closing one can flush
                # buffered records through storage
                with traced_span(f"stage.{self.name}.process", traceparent=msg.traceparent or None,
                                 batch_size=len(tasks), worker_id=handle.worker_id), self._lock:
                    result = stage.process_data(tasks)
                if result is not None and not isinstance(result, list):
                    raise TypeError(f"stage {self.name}.process_data must return list or None")
                out_refs = [object_store.put(t) for t in (result or [])]
                self.results_q.put(ResultMsg(msg.batch_id, out_refs=out_refs,
                                             process_time_s=time.monotonic() - t0 - dt, deserialize_time_s=dt,
                                             worker_id=handle.worker_id))
            except Exception:
                self.results_q.put(ResultMsg(msg.batch_id, error=traceback.format_exc(),
                                             process_time_s=time.monotonic() - t0, worker_id=handle.worker_id))
        fetch_pool.shutdown(wait=False)
        try:
            stage.destroy()
        except Exception:
            pass

    def stop_worker(self, w: WorkerHandle) -> None:
        w.in_q.put(ShutdownMsg())
        self.workers.pop(w.worker_id, None)

    def shutdown(self) -> None:
        """Stop the worker and wait (bounded) for its ``destroy``: the
        stage flushes its artifacts there (the profiler's), and the run's
        finalize collects them right after. The reference returns without
        waiting."""
        super().shutdown()
        deadline = time.monotonic() + self.DESTROY_WAIT_S
        for thread in self._threads:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
        self._threads = [t for t in self._threads if t.is_alive()]


def make_pool(spec: StageSpec, node: NodeInfo, mp_results_q, thread_results_q, pool_id: int = 0,
              prewarm: PrewarmPool | None = None, remote_mgr=None) -> BasePool:
    if spec.stage.resources.uses_gpu:
        # a GPU stage never places remotely: each host's cards belong to
        # that host's engine process
        return InProcessPool(spec, node, thread_results_q, pool_id)
    return ProcessPool(spec, node, mp_results_q, pool_id, prewarm=prewarm, remote_mgr=remote_mgr)
