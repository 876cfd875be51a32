"""Shared-ledger work distribution for multi-node pipeline runs (port of
``cosmos_curate_tpu/parallel/work_stealing.py``; the ledger's layout and
TTL are the reference's, so nodes of either package share one ledger).

Built on the storage layer, not on a cross-node object plane: every node pulls
small batches from one shared claim ledger under the output root, so a node
whose inputs are heavy simply claims fewer batches and a node that drains
early keeps pulling — the 9:1-skew case the static partition cannot fix.

Claim protocol (object-storage friendly, no atomic primitives required):
write ``work_claims/<record_id>.json`` with ``{rank, ts}``, read it back,
and process only if the read returns our rank. The read-back closes the
last-writer-wins window to the storage round-trip; a lost race costs at
most one duplicated task, and duplication is CORRECT here — outputs are
deterministic per task and resume records are idempotent (same property the
reference leans on for its retry semantics). Crashed claimers are covered
by a TTL: stale claims are re-claimable.

Enable on a multi-node run with ``CURATE_WORK_STEALING=1`` (the default
remains the exact static partition, whose disjoint accounting some
workflows assert on).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Sequence

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_TTL_S = 1800.0


def stealing_enabled() -> bool:
    return os.environ.get("CURATE_WORK_STEALING", "0") == "1"


def claim_next_batch(
    tasks: Sequence,
    output_path: str,
    *,
    record_id: Callable[[object], str],
    batch: int = 2,
    ttl_s: float = DEFAULT_TTL_S,
    rank: int | None = None,
) -> list:
    """Claim up to ``batch`` unclaimed (or stale-claimed) tasks.

    Scanning starts at a rank-dependent offset so simultaneous nodes mostly
    race for DIFFERENT tasks; the read-back check settles the rest.
    """
    from cosmos_curate_tpu_torch.parallel.distributed import node_rank_and_count
    from cosmos_curate_tpu_torch.storage.client import get_storage_client

    if rank is None:
        rank, _ = node_rank_and_count()
    client = get_storage_client(output_path)
    root = f"{output_path.rstrip('/')}/work_claims"
    claimed: list = []
    n = len(tasks)
    if n == 0:
        return claimed
    start = (rank * max(1, batch)) % n
    now = time.time()
    for j in range(n):
        task = tasks[(start + j) % n]
        rid = record_id(task)
        path = f"{root}/{rid}.json"
        try:
            rec = json.loads(client.read_bytes(path))
            if now - float(rec.get("ts", 0)) < ttl_s:
                # fresh claim blocks everyone INCLUDING our own rank — a
                # failing task is retried only after the TTL, and a
                # restarted node (same rank, fresh process) can reclaim
                # its own stale claims instead of skipping them forever
                continue
        except Exception:
            pass  # no claim yet (or unreadable: treat as stale)
        client.write_bytes(path, json.dumps({"rank": rank, "ts": now}).encode())
        try:
            winner = json.loads(client.read_bytes(path))
            if int(winner.get("rank", -1)) != rank:
                continue  # lost the write race
        except Exception:
            continue
        claimed.append(task)
        if len(claimed) >= batch:
            break
    if claimed:
        logger.info(
            "claimed %d task(s) from the shared ledger (rank %d)", len(claimed), rank
        )
    return claimed


def _heartbeat_claims(
    output_path: str, rids: list[str], ttl_s: float, stop: threading.Event
) -> None:
    """Re-write the claim records for ``rids`` every ttl/3 until stopped.
    Failures are logged and retried next period — a flaky beat at worst
    allows a duplicate, which the ledger's semantics already tolerate."""
    from cosmos_curate_tpu_torch.parallel.distributed import node_rank_and_count
    from cosmos_curate_tpu_torch.storage.client import get_storage_client

    rank, _ = node_rank_and_count()
    client = get_storage_client(output_path)
    root = f"{output_path.rstrip('/')}/work_claims"
    period = max(1.0, ttl_s / 3.0)
    while not stop.wait(period):
        for rid in rids:
            try:
                client.write_bytes(
                    f"{root}/{rid}.json",
                    json.dumps({"rank": rank, "ts": time.time()}).encode(),
                )
            except Exception:
                logger.exception("claim heartbeat failed for %s", rid)


def run_with_stealing(
    tasks: Sequence,
    output_path: str,
    run_batch: Callable[[list], list],
    *,
    record_id: Callable[[object], str],
    batch: int = 0,
    ttl_s: float = DEFAULT_TTL_S,
    is_done: Callable[[object], bool] | None = None,
    poll_s: float = 15.0,
) -> list:
    """Drain ``tasks`` by pulling claim batches until every task is claimed
    AND finished.

    ``run_batch`` processes one claimed batch and returns its outputs.
    ``batch=0`` (default) sizes claims adaptively — about half a node's
    fair share per pull, shrinking as the ledger drains — so each node pays
    ~2·log(share) pipeline spin-ups instead of one per pair of tasks, while
    the tail still rebalances at fine grain.

    When nothing is claimable but tasks remain (fresh claims held by other
    nodes), the node LINGERS: tasks whose ``is_done`` turns true drop off;
    tasks whose claimer crashed become claimable at the TTL and are taken
    over. Without the linger, a peer crashing after claiming would leave
    its tasks processed by no one while the run reports success. Pass
    ``is_done=None`` to keep the old exit-when-dry behavior."""
    from cosmos_curate_tpu_torch.parallel.distributed import node_rank_and_count

    _, n_nodes = node_rank_and_count()
    out: list = []
    remaining = list(tasks)
    while remaining:
        size = batch or max(1, len(remaining) // (2 * max(1, n_nodes)))
        got = claim_next_batch(
            remaining, output_path, record_id=record_id, batch=size, ttl_s=ttl_s
        )
        if got:
            # heartbeat while the batch runs: an adaptive batch can hold
            # tasks serially for longer than the TTL, and a claim written
            # once would expire mid-run — a peer would take over and
            # duplicate the compute. Refreshing the claim
            # JSONs keeps them fresh for exactly as long as we're alive.
            stop = threading.Event()
            beat = threading.Thread(
                target=_heartbeat_claims,
                args=(output_path, [record_id(t) for t in got], ttl_s, stop),
                daemon=True,
            )
            beat.start()
            try:
                out += run_batch(got) or []
            finally:
                stop.set()
                beat.join(timeout=5)
            claimed_ids = {record_id(t) for t in got}
            remaining = [t for t in remaining if record_id(t) not in claimed_ids]
            continue
        if is_done is None:
            break
        before = len(remaining)
        remaining = [t for t in remaining if not is_done(t)]
        if not remaining:
            break
        if len(remaining) == before:
            logger.info(
                "waiting on %d task(s) claimed elsewhere (takeover after "
                "claim TTL if the claimer died)", len(remaining),
            )
            time.sleep(poll_s)
    return out
