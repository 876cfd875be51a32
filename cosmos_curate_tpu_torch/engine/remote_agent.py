"""Node agent: joins a driver's engine plane and hosts remote stage workers
(port of ``cosmos_curate_tpu/engine/remote_agent.py``).

Run on every non-driver node:

    python -m cosmos_curate_tpu_torch.engine.remote_agent --driver HOST:PORT

or ``cosmos-curate-tpu-torch agent --driver HOST:PORT``. The agent spawns
the port's own workers (engine/worker.py ``worker_main``: spawn, never
fork; the driver's CPU-worker environment, ``CUDA_VISIBLE_DEVICES=""``) and
relays their control and result queues over the authenticated socket. The
control link carries REFS only: input segments stream in from their owner
(the driver's store or a peer agent) over the object channel
(engine/object_channel.py), segments this node already owns are consumed in
place, and outputs stay here until the driver releases them. The agent
imports no torch: device stages never place on it (the card belongs to that
host's engine process), and a CPU worker imports only its stage's modules.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import multiprocessing as mp
import os
import queue
import socket
import threading
import time

from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.engine import object_channel, object_store
from cosmos_curate_tpu_torch.engine.remote_plane import (
    DEFAULT_HEARTBEAT_S,
    HEARTBEAT_S_ENV,
    AgentReady,
    AgentResult,
    AgentStats,
    Bye,
    Hello,
    PrefetchObjects,
    ProtocolSkewError,
    ReleaseObjects,
    StartWorker,
    StopWorker,
    SubmitBatch,
    WorkerDied,
    _token,
    connect_channel,
)
from cosmos_curate_tpu_torch.engine.worker import (
    ProcessMsg,
    ReadyMsg,
    ResultMsg,
    SetupMsg,
    ShutdownMsg,
    worker_main,
)
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_MP = mp.get_context("spawn")

# bounded concurrency for object-channel pulls (demand resolution AND
# push-ahead prefetch share the pool, so prefetch can never starve the
# demand path of sockets — it only uses slots the demand path left idle)
FETCH_CONCURRENCY_ENV = "CURATE_OBJECT_FETCH_CONCURRENCY"
# entries the push-ahead cache may hold before evicting oldest-first; each
# entry is a whole segment in /dev/shm, so the cap bounds prefetch memory
PREFETCH_CACHE_ENV = "CURATE_PREFETCH_CACHE_ENTRIES"


def _host_memory_gb() -> float:
    """This host's RAM in GiB for the Hello (0.0 = unknown; the planner
    then fits on CPUs alone). sysconf, as the runner reads it: no package."""
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / (1 << 30)
    except (OSError, ValueError):
        return 0.0


def _delete_segments_with_prefix(prefix: str) -> int:
    n = 0
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return 0
    for name in names:
        if name.startswith(prefix) and object_store.valid_segment_name(name):
            try:
                os.unlink(os.path.join("/dev/shm", name))
                n += 1
            except OSError:
                pass
    return n


class NodeAgent:
    def __init__(self, driver: str, *, node_id: str | None = None, num_cpus: float | None = None) -> None:
        host, _, port = driver.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        self.node_id = node_id or f"{socket.gethostname()}-{os.getpid()}"
        self.num_cpus = num_cpus if num_cpus is not None else float(os.cpu_count() or 1)
        self.token = _token()
        # guards `workers` and `inflight`: both are mutated from the recv
        # loop, the result-relay thread and the watchdog thread
        self._lock = threading.Lock()
        self.workers: dict[str, tuple[object, object]] = {}  # key -> (in_q, proc)
        # (worker_key, batch_id) -> input refs this agent FETCHED (local
        # copies of remote segments), deleted once the result is relayed (or
        # the worker dies) so /dev/shm never accumulates. Locally-owned
        # input refs (this node's earlier outputs) are NOT tracked here —
        # the driver releases those via ReleaseObjects.
        self.inflight: dict[tuple[str, int], list] = {}
        # (worker_key, batch_id) -> monotonic deadline (SubmitBatch.timeout_s
        # > 0): the watchdog kills workers whose batch outlives it — hang
        # detection for the driver's batch_timeout_s on REMOTE workers.
        # Guarded by self._lock like inflight.
        self.deadlines: dict[tuple[str, int], float] = {}
        self.results_q: mp.Queue = _MP.Queue()
        self._stop = threading.Event()
        # serves THIS node's segments to the driver and peer agents
        self.object_server = object_channel.ObjectServer(self.token)
        self.driver_object_addr: tuple[str, int] = ("", 0)
        self._last_run_id: bytes | None = None
        # this process and every worker it spawns attribute their dispatch/
        # flow/object-plane aggregates to this node
        os.environ["CURATE_NODE_ID"] = self.node_id
        # batch-level input resolution runs here, NOT on the recv loop: a
        # slow multi-segment fetch must not block StartWorker/StopWorker/
        # Release handling, and resolving batch N+1 while the worker chews
        # batch N is exactly the input-prefetch overlap the engine wants
        self._resolve_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="agent-resolve"
        )
        # segment-level pulls (demand + push-ahead prefetch), bounded
        n_fetch = int(os.environ.get(FETCH_CONCURRENCY_ENV, "4"))
        self._fetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, n_fetch), thread_name_prefix="agent-fetch"
        )
        # push-ahead cache: shm_name -> local copy ref, insertion-ordered
        # for oldest-first eviction. The condition guards cache + in-flight
        # set (recv loop, resolve pool and fetch pool all touch them) and
        # lets a resolver WAIT on an in-flight prefetch instead of opening
        # a duplicate transfer for the same segment.
        self._cache_cv = threading.Condition()
        self._prefetched: dict[str, object_store.ObjectRef] = {}
        self._prefetching: set[str] = set()
        self._prefetch_cap = max(1, int(os.environ.get(PREFETCH_CACHE_ENV, "64")))
        # last AgentStats snapshot (totals), so each frame ships deltas;
        # relay + watchdog threads both flush, hence the dedicated lock
        self._op_lock = threading.Lock()
        self._op_prev: dict | None = None
        self._last_op_flush = 0.0
        # heartbeat cadence: the watchdog ships an AgentStats frame — empty
        # deltas included — at least this often, so the driver's failure
        # detector (remote_plane.check_heartbeats) can declare a silent
        # agent dead deterministically. Must match the driver's knob.
        self._heartbeat_s = float(
            os.environ.get(HEARTBEAT_S_ENV, str(DEFAULT_HEARTBEAT_S))
        )

    def run(self, *, connect_timeout_s: float = 60.0, reconnect: bool = True) -> int:
        """Serve the driver until it says Bye.

        A lost link (driver restart, transient network) does NOT end the
        agent: workers are torn down and the agent dials again — a
        rejoining agent is just a fresh Hello to the driver, which re-places
        workers on it at the next autoscale tick. Exit paths: an explicit
        Bye, or the driver staying unreachable past the reconnect window
        (a Bye lost to a RST must not pin the slurm allocation forever) —
        both exit 0."""
        reconnect_s = float(os.environ.get("CURATE_AGENT_RECONNECT_S", "300"))
        while True:
            try:
                said_bye = self._serve_once(connect_timeout_s=connect_timeout_s)
            except OSError as e:
                logger.info("driver unreachable (%s); agent exiting", e)
                return 0
            if said_bye or not reconnect:
                return 0
            logger.info("driver link lost; reconnecting")
            connect_timeout_s = reconnect_s

    def _serve_once(self, *, connect_timeout_s: float) -> bool:
        """One connect→serve cycle; True when the driver sent Bye."""
        object_store.cleanup_stale_segments()
        # the previous cycle's in-flight inputs are dead weight now (their
        # workers were terminated): unlink the shm segments — this agent
        # process stays alive, so the stale-segment janitor never would
        for key, batch_id in list(self.inflight):
            self._release_inflight(key, batch_id)
        # the previous session's push-ahead copies are unreferenced too
        self._clear_prefetch_cache()
        # stale worker results must not leak into the NEW session (the
        # driver would see results for workers it never started)
        try:
            while True:
                self.results_q.get_nowait()
        except queue.Empty:
            pass
        # each cycle gets its OWN stop event: a relay thread stuck in a
        # stalled send can never be revived by a later cycle's clear()
        self._stop = threading.Event()
        with self._lock:
            self.workers.clear()
            self.inflight.clear()
            self.deadlines.clear()
        deadline = time.monotonic() + connect_timeout_s
        while True:  # the driver may come up after the agents (srun races)
            try:
                sock = socket.create_connection(self.addr, timeout=10)
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.5)
                continue
            # the 10s DIAL timeout must not become a RECV deadline: an agent
            # the driver leaves idle (no StartWorker yet, quiet pipeline)
            # would time out mid-session and reconnect-churn every 10
            # seconds. Frames block indefinitely; driver death surfaces as
            # EOF/RST, and the driver's own failure detector covers the
            # reverse direction.
            sock.settimeout(None)
            # mutual-nonce handshake: both sides contribute fresh randomness
            # to the session id, so no recorded session replays (either
            # direction) into this one (see SecureChannel/connect_channel).
            # The handshake retries inside the dial loop: a DYING driver can
            # accept the dial and drop it before acking (its accept loop
            # races shutdown), which must read as "driver not up yet", not
            # "driver unreachable, exit" — the successor driver is seconds
            # away. Version skew is the exception: a skewed driver answers
            # the same way every time, so fail fast with its clear error.
            try:
                self.chan, ack = connect_channel(
                    sock, self.token,
                    Hello(
                        self.node_id, self.num_cpus,
                        object_port=self.object_server.port,
                        memory_gb=_host_memory_gb(),
                        # pid lets the driver tell a same-process reconnect
                        # (segments survived) from a bounced agent (they
                        # did not)
                        pid=os.getpid(),
                    ),
                )
            except ProtocolSkewError:
                sock.close()
                raise
            except (ConnectionError, OSError):
                sock.close()
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.5)
                continue
            self.sock = sock
            break
        self.driver_object_addr = (self.addr[0], ack.driver_object_port)
        # output segments from a PREVIOUS run are unreferenced dead weight;
        # a transient link blip within the SAME run must keep them — the
        # driver still references them as downstream inputs (run_id tells
        # the two apart)
        if self._last_run_id is not None and ack.run_id != self._last_run_id:
            n = _delete_segments_with_prefix(f"cur{os.getpid()}-")
            if n:
                logger.info("dropped %d output segments from the previous run", n)
        self._last_run_id = ack.run_id
        logger.info(
            "agent %s joined driver %s:%d (%.0f cpus)",
            self.node_id, self.addr[0], self.addr[1], self.num_cpus,
        )
        stop = self._stop
        relay = threading.Thread(target=self._relay_results, args=(stop,), daemon=True)
        relay.start()
        watchdog = threading.Thread(target=self._watchdog, args=(stop,), daemon=True)
        watchdog.start()
        said_bye = False
        try:
            while True:
                # chaos network partition (kind=hang): inbound frames stall
                # here, outbound ones in _send — heartbeats miss, and the
                # driver's failure detector declares this node dead. A
                # single falsy check while disarmed. (agent.kill fires in
                # _relay_results, right after a result lands at the driver —
                # the instant a death actually orphans referenced outputs.)
                chaos.fire(chaos.SITE_AGENT_PARTITION)
                msg = self.chan.recv()
                if isinstance(msg, Bye):
                    said_bye = True
                    break
                try:
                    self._handle(msg)
                except Exception:
                    # one poisoned batch/worker must not sever the link
                    logger.exception("agent failed handling %s", type(msg).__name__)
                    if isinstance(msg, SubmitBatch):
                        import traceback

                        self._send(
                            AgentResult(
                                msg.worker_key, msg.batch_id, error=traceback.format_exc()
                            )
                        )
        except (ConnectionError, OSError) as e:
            logger.warning("driver link lost: %s", e)
        finally:
            self._stop.set()
            # best-effort final flush: a short run can finish inside one
            # watchdog cadence, and its transfers still belong in the
            # driver's per-node accounting
            if said_bye:
                self._flush_op_stats(force=True)
            for key, (in_q, _proc) in list(self.workers.items()):
                try:
                    in_q.put(ShutdownMsg())
                except (OSError, ValueError):  # queue already closed/broken
                    logger.debug("shutdown enqueue failed for %s", key, exc_info=True)
            time.sleep(0.2)
            for key, (_in_q, proc) in list(self.workers.items()):
                if proc.is_alive():
                    proc.terminate()
            try:
                sock.close()
            except OSError:
                pass
        return said_bye

    def _send(self, msg) -> None:
        # kind=hang here stalls outbound frames (results, heartbeats) —
        # one half of the agent.partition site; no-op while disarmed
        chaos.fire(chaos.SITE_AGENT_PARTITION)
        # SecureChannel serializes sends internally (per-frame sequence)
        self.chan.send(msg)

    def _handle(self, msg) -> None:
        if isinstance(msg, StartWorker):
            with self._lock:
                stale = self.workers.pop(msg.worker_key, None)
            if stale is not None:
                # a driver retry re-sent StartWorker while the first process
                # was still setting up: terminate it, or its results would
                # keep relaying under the same key (and the process leak)
                logger.warning(
                    "duplicate StartWorker for %s; terminating the old process",
                    msg.worker_key,
                )
                try:
                    stale[1].terminate()
                except Exception:
                    pass
                # the watchdog only scans self.workers, so the popped
                # process's in-flight input segments must be freed here
                for wkey, batch_id in list(self.inflight):
                    if wkey == msg.worker_key:
                        self._release_inflight(wkey, batch_id)
            in_q = _MP.Queue()
            env = dict(msg.env)
            env["CURATE_WORKER_ID"] = msg.worker_key
            env["CURATE_STORE_OWNER"] = str(os.getpid())  # agent owns segments
            # dispatch/flow dumps from this worker attribute to THIS node
            env["CURATE_NODE_ID"] = self.node_id
            proc = _MP.Process(
                target=worker_main,
                args=(in_q, self.results_q, env),
                daemon=True,
                name=msg.worker_key,
            )
            proc.start()
            in_q.put(SetupMsg(msg.stage_pickle, msg.meta_pickle))
            with self._lock:
                self.workers[msg.worker_key] = (in_q, proc)
        elif isinstance(msg, SubmitBatch):
            with self._lock:
                entry = self.workers.get(msg.worker_key)
            if entry is None:
                self._send(
                    AgentResult(
                        msg.worker_key, msg.batch_id, error="unknown worker on agent"
                    )
                )
                return
            # input resolution runs on the bounded resolve pool, never this
            # recv loop: while the worker processes batch N, batch N+1's
            # refs stream in concurrently (the cross-host analogue of the
            # worker's own fetch/process overlap)
            self._resolve_pool.submit(self._resolve_and_dispatch, msg, entry)
        elif isinstance(msg, PrefetchObjects):
            for spec in msg.refs:
                self._start_prefetch(spec)
        elif isinstance(msg, ReleaseObjects):
            for name in msg.names:
                object_store.delete(object_store.ObjectRef(name, 0, 0))
            # released segments can never be named by a future batch: any
            # push-ahead copies of them are dead weight in the cache
            self._clear_prefetch_cache(msg.names)
        elif isinstance(msg, StopWorker):
            with self._lock:
                entry = self.workers.pop(msg.worker_key, None)
            if entry is not None:
                try:
                    entry[0].put(ShutdownMsg())
                except Exception:
                    entry[1].terminate()

    def _resolve_and_dispatch(self, msg: SubmitBatch, entry) -> None:
        """Resolve-pool job: pull the batch's inputs (bounded concurrency,
        prefetch-cache hits first), then hand the batch to its worker.
        Failures report as AgentResult errors — exactly what the inline
        path used to raise into _serve_once's handler."""
        from cosmos_curate_tpu_torch.observability.tracing import traced_span

        try:
            # the agent's own hop in the trace: input resolution (peer/
            # driver fetches over the object channel) parents onto the
            # driver's stage span via the frame's traceparent. No-op
            # unless the agent runs with CURATE_TRACING=1.
            with traced_span(
                "agent.resolve_inputs",
                traceparent=getattr(msg, "traceparent", "") or None,
                worker=msg.worker_key,
                batch_id=msg.batch_id,
                node=self.node_id,
            ):
                refs, fetched = self._resolve_specs(msg.refs)
        except Exception as e:
            import traceback

            # classify: a fetch that died on the object channel (owner
            # unreachable or hung, segment gone with its node) is an INPUT
            # LOSS — the driver reconstructs via lineage instead of burning
            # the batch's user-code retry budget on a vanished ref. NOT a
            # blanket OSError: a local disk-full/fd-exhaustion writing the
            # fetched segment is this node's problem, not an owner loss.
            input_loss = isinstance(
                e, (ConnectionError, FileNotFoundError, TimeoutError)
            )
            try:
                self._send(
                    AgentResult(
                        msg.worker_key, msg.batch_id,
                        error=traceback.format_exc(),
                        input_loss=input_loss,
                    )
                )
            except OSError:
                logger.debug("result send failed after resolve error", exc_info=True)
            return
        # the fetch above can take seconds: the worker may have died and
        # been reaped by the watchdog meanwhile. Re-check under the same
        # lock hold as the inflight insert — inserting for a reaped key
        # would leak the fetched segments forever (the watchdog already
        # scanned inflight and will never revisit this key).
        with self._lock:
            alive = msg.worker_key in self.workers
            if alive:
                self.inflight[(msg.worker_key, msg.batch_id)] = fetched
                if getattr(msg, "timeout_s", 0.0) > 0:
                    # the deadline starts AFTER the input fetch (which
                    # can take seconds and is not the worker's fault)
                    self.deadlines[(msg.worker_key, msg.batch_id)] = (
                        time.monotonic() + msg.timeout_s
                    )
        if not alive:
            # WorkerDied was already reported; the driver requeues the
            # batch — just free this attempt's local copies
            for r in fetched:
                try:
                    object_store.delete(r)
                except OSError:
                    logger.debug("stale-copy delete failed", exc_info=True)
            return
        entry[0].put(
            ProcessMsg(
                batch_id=msg.batch_id,
                refs=refs,
                traceparent=getattr(msg, "traceparent", ""),
            )
        )

    def _fetch_one(self, s) -> object_store.ObjectRef:
        """One demand pull over the object channel, with wait accounting
        (the consumer is blocked for exactly this long)."""
        from cosmos_curate_tpu_torch.observability.stage_timer import record_object_plane

        if s.owner_node == "":  # driver-owned: dial the control host
            addr = self.driver_object_addr
        else:
            addr = (s.owner_host, s.owner_port)
        local = object_store.ObjectRef(s.shm_name, s.total_size, s.num_buffers)
        t0 = time.monotonic()
        copy = object_channel.fetch_object(addr, self.token, local)
        record_object_plane(
            fetches=1, fetch_bytes=s.total_size,
            fetch_wait_s=time.monotonic() - t0,
        )
        return copy

    def _resolve_specs(self, specs) -> tuple[list, list]:
        """RefSpecs -> local ObjectRefs. Segments this node already owns
        are used in place (node affinity: zero bytes moved); push-ahead
        cache hits are consumed with ~zero wait; everything else streams
        from its owner — the driver's store or a PEER agent — through the
        bounded fetch pool, never through the driver's control socket and
        never ref-by-ref sequentially. Returns (refs_for_worker,
        fetched_local_copies)."""
        from cosmos_curate_tpu_torch.observability.stage_timer import record_object_plane

        refs: list = [None] * len(specs)
        fetched: list = []
        futures: list[tuple[int, concurrent.futures.Future]] = []
        deferred: list[tuple[int, object]] = []
        for i, s in enumerate(specs):
            local = object_store.ObjectRef(s.shm_name, s.total_size, s.num_buffers)
            if s.owner_node == self.node_id and os.path.exists(
                object_store.segment_path(s.shm_name)
            ):
                refs[i] = local  # ours already; driver releases it later
                continue
            with self._cache_cv:
                pending = (
                    s.shm_name in self._prefetched or s.shm_name in self._prefetching
                )
            if pending:
                # cached or streaming in: settle AFTER the demand futures
                # are submitted, so waiting on one never delays the others
                deferred.append((i, s))
            else:
                record_object_plane(prefetch_misses=1)
                # copy_context: the fetch spans must parent onto the
                # ambient agent.resolve_inputs span, not fragment the trace
                # from a bare pool thread
                import contextvars

                futures.append(
                    (
                        i,
                        self._fetch_pool.submit(
                            contextvars.copy_context().run, self._fetch_one, s
                        ),
                    )
                )
        err: BaseException | None = None
        for i, s in deferred:
            t0 = time.monotonic()
            hit = self._take_prefetched(s.shm_name)
            if hit is not None:
                record_object_plane(
                    prefetch_hits=1, prefetch_hit_wait_s=time.monotonic() - t0
                )
                refs[i] = hit
                fetched.append(hit)
                continue
            # the in-flight prefetch failed (owner died, segment released):
            # fall back to a demand pull, which reports the real error
            record_object_plane(prefetch_misses=1)
            try:
                copy = self._fetch_one(s)
            except BaseException as e:
                err = err or e
                continue
            refs[i] = copy
            fetched.append(copy)
        for i, fut in futures:
            try:
                copy = fut.result()
            except BaseException as e:  # keep draining: every future must settle
                err = err or e
                continue
            refs[i] = copy
            fetched.append(copy)
        if err is not None:
            # partial failure must not orphan the copies already written
            # (retries would leak a fresh set each attempt)
            for r in fetched:
                try:
                    object_store.delete(r)
                except OSError:
                    logger.debug("cleanup delete failed for %s", r.shm_name, exc_info=True)
            raise err
        return refs, fetched

    # -- push-ahead prefetch -------------------------------------------
    def _take_prefetched(
        self, name: str, wait_s: float = 30.0
    ) -> object_store.ObjectRef | None:
        """Consume a cached push-ahead copy. When the transfer is still IN
        FLIGHT, wait for it rather than racing a duplicate demand fetch —
        the residual wait is strictly shorter than a fresh transfer, and
        the caller's hit-wait accounting captures exactly that residue."""
        deadline = time.monotonic() + wait_s
        with self._cache_cv:
            while True:
                if name in self._prefetched:
                    return self._prefetched.pop(name)
                if name not in self._prefetching:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cache_cv.wait(remaining)

    def _start_prefetch(self, spec) -> None:
        """Begin pulling one pushed-ahead segment into the cache unless it
        is already local, cached, or in flight."""
        if spec.owner_node == self.node_id:
            return
        with self._cache_cv:
            if spec.shm_name in self._prefetched or spec.shm_name in self._prefetching:
                return
            self._prefetching.add(spec.shm_name)
        self._fetch_pool.submit(self._prefetch_one, spec)

    def _prefetch_one(self, spec) -> None:
        from cosmos_curate_tpu_torch.observability.stage_timer import record_object_plane
        from cosmos_curate_tpu_torch.observability.tracing import suppress_tracing

        evicted: list = []
        try:
            addr = (
                self.driver_object_addr
                if spec.owner_node == ""
                else (spec.owner_host, spec.owner_port)
            )
            ref = object_store.ObjectRef(
                spec.shm_name, spec.total_size, spec.num_buffers
            )
            t0 = time.monotonic()
            # background traffic with no batch to parent onto: an untraced
            # pull keeps the run's trace connected (the object-plane
            # counters carry the prefetch signal)
            with suppress_tracing():
                copy = object_channel.fetch_object(addr, self.token, ref)
            record_object_plane(
                prefetches=1, prefetch_bytes=spec.total_size,
                prefetch_transfer_s=time.monotonic() - t0,
            )
            with self._cache_cv:
                self._prefetched[spec.shm_name] = copy
                while len(self._prefetched) > self._prefetch_cap:
                    evicted.append(self._prefetched.pop(next(iter(self._prefetched))))
        except (ConnectionError, OSError, FileNotFoundError) as e:
            # advisory: the demand pull will retry from the owner; a
            # released-before-prefetch segment is a normal race
            logger.debug("prefetch of %s failed: %s", spec.shm_name, e)
        finally:
            with self._cache_cv:
                self._prefetching.discard(spec.shm_name)
                self._cache_cv.notify_all()
        for r in evicted:
            try:
                object_store.delete(r)
            except OSError:
                logger.debug("evicted-prefetch delete failed", exc_info=True)

    def _clear_prefetch_cache(self, names=None) -> None:
        """Drop cached push-ahead copies (all of them, or just ``names`` —
        e.g. segments the driver released, which no future batch can
        name)."""
        with self._cache_cv:
            if names is None:
                dead, self._prefetched = list(self._prefetched.values()), {}
            else:
                dead = [
                    self._prefetched.pop(n)
                    for n in names
                    if n in self._prefetched
                ]
        for r in dead:
            try:
                object_store.delete(r)
            except OSError:
                logger.debug("prefetch-cache delete failed", exc_info=True)

    def _release_inflight(self, worker_key: str, batch_id: int) -> None:
        with self._lock:
            refs = self.inflight.pop((worker_key, batch_id), [])
            self.deadlines.pop((worker_key, batch_id), None)
        for r in refs:
            try:
                object_store.delete(r)
            except OSError:  # segment already unlinked: nothing to release
                pass

    def _flush_op_stats(
        self, *, min_interval_s: float = 1.0, force: bool = False,
        heartbeat: bool = False,
    ) -> None:
        """Ship object-plane DELTAS to the driver, throttled (relay thread
        after results, watchdog on cadence, teardown forced).

        ``heartbeat=True`` (the watchdog's cadence call) sends the frame
        even when the delta is empty: the driver's failure detector keys
        agent liveness on frame arrival, and an idle-but-healthy agent must
        not read as a dead one."""
        from cosmos_curate_tpu_torch.observability.stage_timer import (
            object_plane_snapshot_delta,
        )

        with self._op_lock:
            now = time.monotonic()
            if not force and now - self._last_op_flush < min_interval_s:
                return
            self._last_op_flush = now
            self._op_prev, delta = object_plane_snapshot_delta(self._op_prev)
        if delta or heartbeat:
            try:
                self._send(AgentStats(object_plane=delta))
            except OSError:
                logger.debug("stats flush failed (link down?)", exc_info=True)

    def _relay_results(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                msg = self.results_q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                if isinstance(msg, ReadyMsg):
                    self._send(AgentReady(msg.worker_id, error=msg.error))
                elif isinstance(msg, ResultMsg):
                    self._release_inflight(msg.worker_id, msg.batch_id)
                    if msg.error is not None:
                        self._send(
                            AgentResult(
                                msg.worker_id,
                                msg.batch_id,
                                error=msg.error,
                                process_time_s=msg.process_time_s,
                            )
                        )
                        continue
                    # outputs STAY in this node's store; only descriptors
                    # ride the control link. Consumers pull the bytes from
                    # our ObjectServer; the driver sends ReleaseObjects when
                    # the last consumer is done.
                    self._send(
                        AgentResult(
                            msg.worker_id,
                            msg.batch_id,
                            out_refs=[
                                (r.shm_name, r.total_size, r.num_buffers)
                                for r in msg.out_refs
                            ],
                            process_time_s=msg.process_time_s,
                            deserialize_time_s=msg.deserialize_time_s,
                        )
                    )
                    # piggyback transfer stats on result traffic so even a
                    # run shorter than the watchdog cadence reports
                    self._flush_op_stats()
                    # chaos: the most hostile node-death instant — the
                    # result (and its output descriptors) just reached the
                    # driver, so downstream batches WILL reference segments
                    # that die with this process. kind=crash (os._exit).
                    chaos.fire(chaos.SITE_AGENT_KILL)
            except OSError:
                return

    def _watchdog(self, stop: threading.Event) -> None:
        """Detect remote worker PROCESS deaths (the driver can only see the
        link): report WorkerDied so the driver's reap requeues the batch,
        and free the dead worker's in-flight input segments. Also enforces
        per-batch deadlines (SubmitBatch.timeout_s): a worker whose batch
        outlives its deadline is presumed hung, killed, and reported
        through the same WorkerDied path as a real death."""
        tick = min(1.0, self._heartbeat_s / 2) if self._heartbeat_s > 0 else 1.0
        while not stop.is_set():
            time.sleep(tick)
            now = time.monotonic()
            # relay object-plane deltas so the driver's per-node counters
            # and run report cover this node's transfers even while no
            # results flow — AND serve as the liveness heartbeat the
            # driver's failure detector deadlines against (empty deltas
            # still send a frame)
            self._flush_op_stats(
                min_interval_s=max(0.2, self._heartbeat_s), heartbeat=True
            )
            with self._lock:
                expired = [k for k, d in self.deadlines.items() if now >= d]
            for key, batch_id in expired:
                with self._lock:
                    entry = self.workers.pop(key, None)
                    self.deadlines.pop((key, batch_id), None)
                if entry is None:
                    continue  # already reaped as a death
                logger.warning(
                    "worker %s batch %d exceeded its deadline on agent; "
                    "killing hung worker", key, batch_id,
                )
                try:
                    entry[1].kill()  # SIGKILL: hung code may ignore SIGTERM
                    entry[1].join(timeout=2.0)
                except (OSError, AttributeError):
                    logger.debug("kill failed for %s", key, exc_info=True)
                for wkey, b_id in list(self.inflight):
                    if wkey == key:
                        self._release_inflight(wkey, b_id)
                try:
                    self._send(WorkerDied(key))
                except OSError:
                    return
            for key, (_in_q, proc) in list(self.workers.items()):
                if proc.is_alive():
                    continue
                with self._lock:
                    self.workers.pop(key, None)
                logger.warning("worker %s died on agent (exit %s)", key, proc.exitcode)
                for wkey, batch_id in list(self.inflight):
                    if wkey == key:
                        self._release_inflight(wkey, batch_id)
                try:
                    self._send(WorkerDied(key))
                except OSError:
                    return


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="cosmos-curate-tpu-torch engine node agent")
    ap.add_argument("--driver", required=True, help="driver HOST:PORT")
    ap.add_argument("--node-id", default=None)
    ap.add_argument("--num-cpus", type=float, default=None)
    args = ap.parse_args(argv)
    from cosmos_curate_tpu_torch import chaos
    from cosmos_curate_tpu_torch.observability.tracing import setup_tracing_from_env

    chaos.install_from_env()  # soak rigs arm agent-side faults via env
    setup_tracing_from_env()  # CURATE_TRACING=1 joins the agent to the trace
    return NodeAgent(args.driver, node_id=args.node_id, num_cpus=args.num_cpus).run()


if __name__ == "__main__":
    raise SystemExit(main())
