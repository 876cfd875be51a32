"""Stage worker process: the streaming engine's unit of execution (port of
``cosmos_curate_tpu/engine/worker.py``).

A worker's life: setup_on_node -> setup -> the process_data loop ->
destroy, with a prefetch thread that fetches and deserializes the next
batch's inputs from the object store while the current batch runs.

Workers are spawned, never forked (a forked CUDA context is unusable), and
a CPU worker runs with ``CUDA_VISIBLE_DEVICES=""`` (engine/pool.py): it never
creates a CUDA context, which would take device memory from the driver's
device stages. No module a worker imports touches ``torch.cuda`` on import.

A worker arms the chaos plan of ``CURATE_CHAOS`` at bring-up (and again
when a prewarmed spare is adopted: the adopter's environment may arm what
the spare was spawned without). The same worker runs under a node agent
(engine/remote_agent.py), whose relay sets ``ResultMsg.input_loss`` for a
batch whose inputs could not be fetched from their owner.
"""

from __future__ import annotations

import concurrent.futures
import os
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any

import cloudpickle

from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.engine import object_store
from cosmos_curate_tpu_torch.observability.stage_timer import record_object_plane
from cosmos_curate_tpu_torch.observability.tracing import setup_tracing_from_env, traced_span


@dataclass
class SetupMsg:
    stage_pickle: bytes
    worker_meta_pickle: bytes
    # set when a prewarmed spare is adopted by a pool: applied before the
    # stage loads, so the worker id and tracing are the adopter's
    env: dict[str, str] | None = None


@dataclass
class ProcessMsg:
    batch_id: int
    refs: list[object_store.ObjectRef]
    # per-batch deadline (StageSpec.batch_timeout_s); 0 = none. The runner
    # enforces it (a hung worker cannot run its own timer)
    timeout_s: float = 0.0
    # W3C trace context of the driver's stage span: the worker's process
    # span parents onto it. '' when tracing is off
    traceparent: str = ""


@dataclass
class ShutdownMsg:
    pass


@dataclass
class ResultMsg:
    batch_id: int
    out_refs: list[object_store.ObjectRef] = field(default_factory=list)
    error: str | None = None
    process_time_s: float = 0.0
    deserialize_time_s: float = 0.0
    worker_id: str = ""
    # the error is a lost input (an object-channel fetch from a dead or
    # unreachable owner), not user code failing: the runner routes it to
    # lineage reconstruction instead of the num_run_attempts budget. Only
    # the remote plane's relay (remote_plane.AgentResult) sets it.
    input_loss: bool = False


@dataclass
class ReadyMsg:
    worker_id: str
    error: str | None = None


# bounded fan-out of one batch's input fetches: segments deserialize
# concurrently, so a batch's fetch takes about its largest segment's time
FETCH_THREADS_ENV = "CURATE_WORKER_FETCH_THREADS"


def _fetch_batch(refs: list, pool) -> list[Any]:
    """Deserialize a batch's refs through the bounded pool (order kept),
    recording bytes and wait in the object-plane aggregate. A one-ref batch
    skips the pool."""
    t0 = time.monotonic()
    if pool is None or len(refs) <= 1:
        tasks = [object_store.get(r) for r in refs]
    else:
        tasks = list(pool.map(object_store.get, refs))
    record_object_plane(store_reads=len(refs), store_read_bytes=sum(r.total_size for r in refs),
                        store_read_wait_s=time.monotonic() - t0)
    return tasks


def worker_main(in_q, out_q, env: dict[str, str]) -> None:
    """Entry point of a spawned worker process."""
    os.environ.update(env)
    setup_tracing_from_env()
    # armed once at bring-up; while disarmed a site costs one falsy check
    chaos.install_from_env()
    stage = None
    worker_id = env.get("CURATE_WORKER_ID", "worker-?")
    # prefetch pipeline: control messages -> deserialized batches
    fetched: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()
    n_fetch = max(1, int(os.environ.get(FETCH_THREADS_ENV, "4")))
    fetch_pool = concurrent.futures.ThreadPoolExecutor(max_workers=n_fetch, thread_name_prefix=f"{worker_id}-fetch")
    parent_pid = os.getppid()

    def fetcher() -> None:
        while not stop.is_set():
            try:
                msg = in_q.get(timeout=0.2)
            except queue.Empty:
                if os.getppid() != parent_pid:
                    # orphaned: the driver died without cleanup
                    fetched.put((ShutdownMsg(), None, None, 0.0))
                    return
                continue
            if isinstance(msg, ShutdownMsg):
                fetched.put((msg, None, None, 0.0))
                return
            if isinstance(msg, SetupMsg):
                fetched.put((msg, None, None, 0.0))
                continue
            t0 = time.monotonic()
            try:
                tasks = _fetch_batch(msg.refs, fetch_pool)
                fetched.put((msg, tasks, None, time.monotonic() - t0))
            except Exception:
                fetched.put((msg, None, traceback.format_exc(), time.monotonic() - t0))

    threading.Thread(target=fetcher, daemon=True).start()

    try:
        while True:
            msg, tasks, fetch_err, dt = fetched.get()
            if isinstance(msg, ShutdownMsg):
                break
            if isinstance(msg, SetupMsg):
                try:
                    if msg.env:
                        os.environ.update(msg.env)
                        worker_id = msg.env.get("CURATE_WORKER_ID", worker_id)
                        setup_tracing_from_env()
                        chaos.install_from_env()
                    stage = cloudpickle.loads(msg.stage_pickle)
                    meta = cloudpickle.loads(msg.worker_meta_pickle)
                    stage.setup_on_node(meta.node, meta)
                    stage.setup(meta)
                    out_q.put(ReadyMsg(worker_id=worker_id))
                except Exception:
                    out_q.put(ReadyMsg(worker_id=worker_id, error=traceback.format_exc()))
                continue
            if fetch_err is not None:
                out_q.put(ResultMsg(msg.batch_id, error=fetch_err, worker_id=worker_id))
                continue
            t0 = time.monotonic()
            try:
                chaos.fire(chaos.SITE_WORKER_CRASH)  # kind=crash: os._exit
                chaos.fire(chaos.SITE_WORKER_HANG)  # kind=hang: stuck batch
                # Stage.name, not the class name: the observability wrappers
                # subclass at run time, and the report books time by name
                with traced_span(f"stage.{getattr(stage, 'name', type(stage).__name__)}.process",
                                 traceparent=msg.traceparent or None, batch_size=len(tasks), worker_id=worker_id):
                    result = stage.process_data(tasks)
                if result is not None and not isinstance(result, list):
                    raise TypeError(f"stage {type(stage).__name__}.process_data must return "
                                    f"list or None, got {type(result).__name__}")
                out_refs = [object_store.put(t) for t in (result or [])]
                out_q.put(ResultMsg(msg.batch_id, out_refs=out_refs, process_time_s=time.monotonic() - t0,
                                    deserialize_time_s=dt, worker_id=worker_id))
            except Exception:
                out_q.put(ResultMsg(msg.batch_id, error=traceback.format_exc(),
                                    process_time_s=time.monotonic() - t0, worker_id=worker_id))
    finally:
        stop.set()
        fetch_pool.shutdown(wait=False)
        if stage is not None:
            try:
                stage.destroy()
            except Exception:
                pass
