"""Admission control: priority lanes, per-tenant quotas, load shedding (port
of ``cosmos_curate_tpu/service/admission.py``).

Replaces the reference's one-pipeline-at-a-time lock (the NVCF wrapper's
middleware, reproduced in the old ``service/app.py``) with the admission
shape heavy multi-tenant traffic needs:

- **Priority lanes.** Two lanes, ``interactive`` and ``batch``; the
  dispatcher always drains ``interactive`` first. Within a lane each
  tenant has its own FIFO and tenants are served round-robin, so one
  tenant's thousand-job backfill cannot starve another's single job.
- **Quotas.** Per-tenant queued and running caps plus a global queued cap.
  Over-quota submissions are *shed* — a ``429`` with ``Retry-After`` —
  instead of accepted into an unbounded queue (or the old ``409``-forever).
- **Capacity.** The dispatcher runs up to ``max_concurrent_jobs`` jobs,
  additionally clamped by the host's :class:`~cosmos_curate_tpu_torch.engine.autoscaler.NodeBudget`
  (CPU/memory) under a per-job cost estimate — the same accounting the
  cross-host planner uses, so a 2-core box never dispatches 8 pipelines.

Pure data structure + policy: no IO, no clocks beyond the records' own
timestamps, trivially unit-testable. The service (``service/app.py``)
owns journaling and subprocesses.
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass
from typing import Iterable

from cosmos_curate_tpu_torch.engine.autoscaler import NodeBudget
from cosmos_curate_tpu_torch.service.job_queue import LANES, JobRecord
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass(frozen=True)
class QuotaConfig:
    """Admission knobs. Defaults are sized for a small box; the serve CLI
    exposes all of them."""

    max_concurrent_jobs: int = 2
    max_running_per_tenant: int = 2
    max_queued_per_tenant: int = 8
    max_queued_total: int = 64
    # dispatcher-side resource estimate per job (a pipeline subprocess
    # spawns its own worker pool, so one job ≈ one core minimum)
    cpus_per_job: float = 1.0
    memory_gb_per_job: float = 0.0
    retry_after_s: float = 5.0  # base Retry-After hint; scaled by backlog
    # cap on DISTINCT tenants ever admitted: the tenant string is
    # client-chosen and becomes per-tenant queue structures and a
    # prometheus label — without a cap, randomized tenant names are an
    # unbounded-memory (and quota-bypass) vector
    max_tenants: int = 256


@dataclass(frozen=True)
class Decision:
    """``admit`` outcome: accepted into a lane, or shed with the reason
    that becomes the 429 body + ``service_shed_total{reason}`` label."""

    admitted: bool
    reason: str = ""
    retry_after_s: float = 0.0


def host_budget() -> NodeBudget:
    """This host as a :class:`NodeBudget` (the planner's accounting unit).
    Memory probe is best-effort — 0.0 disables the memory clamp, matching
    the planner's "participates only where both sides declare" rule."""
    mem_gb = 0.0
    try:
        import psutil

        mem_gb = psutil.virtual_memory().total / 2**30
    except Exception:  # psutil absent or /proc unreadable: CPU clamp only
        pass
    return NodeBudget(node_id="", cpus=float(os.cpu_count() or 1), memory_gb=mem_gb)


class AdmissionController:
    """Lane/tenant queues + the quota and capacity policy.

    Not thread-safe by itself: the service drives it from one event loop.
    """

    def __init__(self, cfg: QuotaConfig, budget: NodeBudget | None = None) -> None:
        self.cfg = cfg
        self.budget = budget or host_budget()
        # lane -> tenant -> FIFO of queued records
        self._lanes: dict[str, dict[str, deque[JobRecord]]] = {
            lane: {} for lane in LANES
        }
        # lane -> tenant round-robin order (rotated on every pop)
        self._rr: dict[str, deque[str]] = {lane: deque() for lane in LANES}
        self._known_tenants: set[str] = set()  # bounded by cfg.max_tenants

    # ---- introspection -------------------------------------------------

    def is_known_tenant(self, tenant: str) -> bool:
        """True once a tenant has been admitted at least once. Metric
        labels for unknown tenants must use a sentinel — shedding a
        never-admitted tenant must not mint the label series the
        ``max_tenants`` cap exists to bound."""
        return tenant in self._known_tenants

    def queued_total(self) -> int:
        return sum(
            len(q) for lane in self._lanes.values() for q in lane.values()
        )

    def queued_for(self, tenant: str) -> int:
        return sum(len(lane.get(tenant, ())) for lane in self._lanes.values())

    def lane_depth(self, lane: str) -> int:
        return sum(len(q) for q in self._lanes[lane].values())

    def queued_records(self) -> list[JobRecord]:
        out: list[JobRecord] = []
        for lane in LANES:
            for q in self._lanes[lane].values():
                out.extend(q)
        return out

    def effective_max_running(self) -> int:
        """The dispatcher cap after the host budget clamp: never more jobs
        than the host has CPU (and, when both sides declare, memory) for."""
        cap = self.cfg.max_concurrent_jobs
        if self.cfg.cpus_per_job > 0:
            cap = min(cap, int(self.budget.cpus // self.cfg.cpus_per_job))
        if self.cfg.memory_gb_per_job > 0 and self.budget.memory_gb > 0:
            cap = min(
                cap, int(self.budget.memory_gb // self.cfg.memory_gb_per_job)
            )
        return max(1, cap)  # a 0.5-core container still runs one job

    def _retry_after(self, extra_backlog: int = 0) -> float:
        """Retry-After hint: base, scaled by how many dispatch slots the
        backlog represents. Coarse on purpose — it only needs to spread a
        herd of retries, not predict completion."""
        slots = self.effective_max_running()
        backlog = self.queued_total() + extra_backlog
        return round(self.cfg.retry_after_s * (1.0 + backlog / max(1, slots)), 1)

    # ---- admission -----------------------------------------------------

    def admit(self, record: JobRecord) -> Decision:
        """Quota check + enqueue. Sheds (never queues) when over quota."""
        if record.priority not in LANES:
            return Decision(False, reason=f"unknown lane {record.priority!r}")
        if (
            record.tenant not in self._known_tenants
            and len(self._known_tenants) >= self.cfg.max_tenants
        ):
            return Decision(
                False, reason="tenant_limit", retry_after_s=self._retry_after()
            )
        if self.queued_total() >= self.cfg.max_queued_total:
            return Decision(
                False, reason="queue_full", retry_after_s=self._retry_after()
            )
        if self.queued_for(record.tenant) >= self.cfg.max_queued_per_tenant:
            return Decision(
                False, reason="tenant_queue_full", retry_after_s=self._retry_after()
            )
        self._enqueue(record)
        return Decision(True)

    def _enqueue(self, record: JobRecord) -> None:
        self._known_tenants.add(record.tenant)
        lane = self._lanes[record.priority]
        if record.tenant not in lane:
            lane[record.tenant] = deque()
            self._rr[record.priority].append(record.tenant)
        lane[record.tenant].append(record)

    def requeue(self, record: JobRecord) -> None:
        """Unconditional re-enqueue: retries and crash-recovered jobs were
        already admitted once and must not be shed on the way back in."""
        self._enqueue(record)

    def remove(self, job_id: str) -> JobRecord | None:
        """Drop a queued record (terminate-before-start)."""
        for lane in LANES:
            for tenant, q in self._lanes[lane].items():
                for rec in q:
                    if rec.job_id == job_id:
                        q.remove(rec)
                        return rec
        return None

    # ---- dispatch ------------------------------------------------------

    def pop_next(self, running: Iterable[JobRecord]) -> JobRecord | None:
        """The next record to dispatch, or None when at capacity / empty.

        Interactive lane strictly first; within a lane, round-robin across
        tenants (skipping tenants at their running cap), FIFO within a
        tenant."""
        running = list(running)
        if len(running) >= self.effective_max_running():
            return None
        running_by_tenant: dict[str, int] = {}
        for rec in running:
            running_by_tenant[rec.tenant] = running_by_tenant.get(rec.tenant, 0) + 1
        for lane in LANES:  # ("interactive", "batch") — priority order
            order = self._rr[lane]
            for _ in range(len(order)):
                tenant = order[0]
                order.rotate(-1)
                q = self._lanes[lane].get(tenant)
                if not q:
                    continue
                if (
                    running_by_tenant.get(tenant, 0)
                    >= self.cfg.max_running_per_tenant
                ):
                    continue
                return q.popleft()
        return None
