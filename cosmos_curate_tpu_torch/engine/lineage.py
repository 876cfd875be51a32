"""Bounded object lineage for mid-run node-loss reconstruction (port of
``cosmos_curate_tpu/engine/lineage.py``).

Lineage-based object reconstruction, as in Ray's ownership model: when
a node dies mid-run, every object it owned is re-derivable from *how it was
produced* instead of being data loss. The runner records, per live
intermediate ref, the ``(stage, input_refs)`` that produced it; when a
fetch fails because the owner node is dead, the producing batch is
re-enqueued at its stage (recursively, up to a depth/budget) and the
waiting batch re-enters dispatch once its inputs re-materialize.

The tracker is deliberately BOUNDED, not a run-long log:

- a record exists only while at least one of its output refs is still
  referenced by queued/in-flight downstream work — every record entry
  drops at ``store.release`` of its output;
- a record *holds* its input refs: their **physical** delete (the shm
  unlink / ReleaseObjects to the owner) is deferred until the record dies,
  so re-execution always has real inputs to read. Ledger accounting is
  NOT deferred — ``StoreBudget.release`` unaccounts immediately, so input
  seeding/backpressure behave exactly as before; the cost is one extra
  *generation* of segments resident per stage edge.

Non-deterministic stages are fine: reconstruction has reference semantics
(the regenerated outputs replace the lost refs positionally — same clips
out, possibly different bytes), matching Ray's semantics for
non-deterministic tasks.

The tracker is also the runner's location-aware deleter: it wraps the
inner deleter (``RemoteWorkerManager.release_data``) and decides per
release whether the physical delete proceeds now or is deferred.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# knobs (read by the runner):
# how many producer generations a reconstruction may walk back, and how
# many producing batches one run may re-enqueue before giving up (the
# batch then dead-letters with the lost chain).
RECONSTRUCT_DEPTH_ENV = "CURATE_RECONSTRUCT_DEPTH"
RECONSTRUCT_BUDGET_ENV = "CURATE_RECONSTRUCT_BUDGET"
DEFAULT_RECONSTRUCT_DEPTH = 8
DEFAULT_RECONSTRUCT_BUDGET = 256


@dataclass
class LineageRecord:
    """One producing batch: which stage ran it, the exact input refs it
    consumed (held — physically retained until the record dies), and its
    output names in production order (positional identity: regenerated
    output i replaces lost output i)."""

    stage_idx: int
    input_refs: list
    out_names: list
    live: set = field(default_factory=set)
    # batch_id of an in-flight reconstruction re-running this record
    # (dedup: two consumers losing two outputs of one batch re-run it once)
    inflight_batch: int | None = None
    # inputs unheld exactly once, when the record can never be re-run again
    retired: bool = False

    @property
    def stage(self) -> int:
        return self.stage_idx


class LineageTracker:
    """Record/settle lineage and defer held inputs' physical deletes.

    Used as the ``StoreBudget`` deleter: ``__call__(ref)`` settles the
    ref's lineage and either physically deletes it (via the wrapped
    ``deleter``) or defers the delete until no live record holds it."""

    def __init__(self, deleter) -> None:
        self._deleter = deleter
        self._records: dict[str, LineageRecord] = {}  # out name -> record
        self._holds: dict[str, int] = {}  # input name -> live-record count
        self._deferred: dict[str, object] = {}  # released-but-held refs

    # -- recording ------------------------------------------------------
    def record(self, stage_idx: int, input_refs: list, out_refs: list) -> LineageRecord:
        """Register a completed batch's lineage: every output becomes
        re-derivable from ``input_refs`` at ``stage_idx``; the inputs are
        held (physical delete deferred) until every output releases."""
        rec = LineageRecord(
            stage_idx=stage_idx,
            input_refs=list(input_refs),
            out_names=[r.shm_name for r in out_refs],
            live={r.shm_name for r in out_refs},
        )
        for r in out_refs:
            self._records[r.shm_name] = rec
        for r in input_refs:
            self._holds[r.shm_name] = self._holds.get(r.shm_name, 0) + 1
        return rec

    def producer(self, name: str) -> LineageRecord | None:
        return self._records.get(name)

    def is_held(self, name: str) -> bool:
        return bool(self._holds.get(name))

    @property
    def num_records(self) -> int:
        """Distinct live records (bounded-memory observability)."""
        return len({id(r) for r in self._records.values()})

    # -- release (the StoreBudget deleter) ------------------------------
    def __call__(self, ref) -> None:
        if self.release(ref):
            self._delete(ref)

    def release(self, ref) -> bool:
        """Settle ``ref``'s lineage on store release. Returns True when the
        physical delete should proceed now; False when it is deferred
        because a live record still holds the ref as a reconstruction
        input — in that case the ref's own producer record survives too,
        so a DEEP loss (the held bytes died with their node) can walk one
        more generation up."""
        name = ref.shm_name
        rec = self._records.get(name)
        if rec is not None:
            rec.live.discard(name)
            self._maybe_retire(rec)
        if self._holds.get(name):
            # still a reconstruction input of a live record: bytes AND
            # lineage entry survive (depth > 1 needs the producer lookup)
            self._deferred[name] = ref
            return False
        self._records.pop(name, None)
        return True

    def _maybe_retire(self, rec: LineageRecord) -> None:
        """Unhold a record's inputs once NOTHING can re-run it again: every
        output released AND no output still held as a downstream record's
        input (a deferred output still needs its producer re-runnable)."""
        if rec.retired or rec.live:
            return
        if any(self._holds.get(n) for n in rec.out_names):
            return
        rec.retired = True
        for ir in rec.input_refs:
            self._unhold(ir)

    def _unhold(self, ref) -> None:
        name = ref.shm_name
        n = self._holds.get(name, 0) - 1
        if n > 0:
            self._holds[name] = n
            return
        self._holds.pop(name, None)
        dead = self._deferred.pop(name, None)
        if dead is not None:
            self._delete(dead)
        rec = self._records.get(name)
        if rec is not None and name not in rec.live:
            # released and no longer held: the lineage entry is dead, and
            # its producer may now retire too (upstream cascade)
            self._records.pop(name, None)
            self._maybe_retire(rec)

    def _delete(self, ref) -> None:
        try:
            self._deleter(ref)
        except Exception:  # a failed unlink must never break the loop
            logger.debug("lineage delete failed for %s", ref.shm_name, exc_info=True)

    # -- introspection --------------------------------------------------
    def chain(self, name: str, stage_names: list | None = None, depth: int = 8) -> list:
        """Human-readable producer chain for one lost name (DLQ metadata:
        what reconstruction would have walked). Each entry names the
        producing stage and its input refs; the walk follows the first
        input that itself has a record."""
        out: list = []
        seen: set[int] = set()
        cur: str | None = name
        while cur is not None and len(out) < depth:
            rec = self._records.get(cur)
            if rec is None or id(rec) in seen:
                break
            seen.add(id(rec))
            stage = (
                stage_names[rec.stage_idx]
                if stage_names is not None and 0 <= rec.stage_idx < len(stage_names)
                else f"stage[{rec.stage_idx}]"
            )
            out.append(
                {
                    "ref": cur,
                    "produced_by_stage": stage,
                    "inputs": [r.shm_name for r in rec.input_refs],
                }
            )
            cur = next(
                (r.shm_name for r in rec.input_refs if r.shm_name in self._records),
                None,
            )
        return out

    def drain(self) -> int:
        """Run-end cleanup: physically delete every still-deferred ref and
        clear all state. Returns how many deferred refs were flushed."""
        dead = list(self._deferred.values())
        self._records.clear()
        self._holds.clear()
        self._deferred.clear()
        for ref in dead:
            self._delete(ref)
        return len(dead)
