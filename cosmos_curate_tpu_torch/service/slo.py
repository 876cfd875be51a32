"""Per-tenant SLO tracking for the job service (port of
``cosmos_curate_tpu/service/slo.py``).

The admission layer (service/admission.py) decides WHO runs; this module
answers whether the service is honoring its promises to each tenant once
they do: queue wait (pending → running), run duration (running → done), and
success rate over a rolling window of terminal outcomes. Targets are
configured per deployment (``serve --slo-*`` knobs); a breach increments
``service_slo_breaches_total{tenant,kind}`` and is journaled against the
job, and ``GET /v1/slo`` reports every tenant's observed numbers against
the targets — the page-worthy view an operator (or an autoscaler) reads.

Pure data structure like AdmissionController: no IO, no clocks of its own
(callers pass the measured values), driven from the service event loop.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

SLO_KINDS = ("queue_wait", "run_duration", "success_rate")

# a success-rate verdict needs a minimum sample before it can breach —
# one failed first job is not a 0% success rate worth paging on
MIN_OUTCOMES_FOR_RATE = 5


@dataclass(frozen=True)
class SloConfig:
    """Targets; 0 disables a dimension (the default — SLOs are opt-in)."""

    queue_wait_s: float = 0.0  # max acceptable pending→running wait
    run_duration_s: float = 0.0  # max acceptable running→terminal duration
    success_rate: float = 0.0  # min fraction of done outcomes, in (0, 1]
    window: int = 100  # rolling terminal-outcome window per tenant

    @property
    def enabled(self) -> bool:
        return bool(self.queue_wait_s or self.run_duration_s or self.success_rate)


@dataclass
class _TenantStats:
    jobs: int = 0
    queue_wait_sum_s: float = 0.0
    queue_wait_max_s: float = 0.0
    dispatches: int = 0
    duration_sum_s: float = 0.0
    duration_max_s: float = 0.0
    completed: int = 0
    outcomes: deque = field(default_factory=lambda: deque(maxlen=100))
    breaches: dict = field(default_factory=lambda: {k: 0 for k in SLO_KINDS})


class SloTracker:
    """Folds dispatch/terminal observations per tenant; returns breaches.

    Bounded: tenants are capped by the admission controller's max_tenants
    upstream, so per-tenant state here cannot grow unboundedly either."""

    def __init__(self, config: SloConfig | None = None) -> None:
        self.config = config or SloConfig()
        self._tenants: dict[str, _TenantStats] = {}

    def _stats(self, tenant: str) -> _TenantStats:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantStats(
                outcomes=deque(maxlen=max(1, self.config.window))
            )
        return st

    # ------------------------------------------------------------------
    def observe_dispatch(self, tenant: str, wait_s: float) -> list[str]:
        """One pending→running transition. Returns the breached kinds."""
        st = self._stats(tenant)
        st.dispatches += 1
        st.queue_wait_sum_s += max(0.0, wait_s)
        st.queue_wait_max_s = max(st.queue_wait_max_s, wait_s)
        cfg = self.config
        if cfg.queue_wait_s and wait_s > cfg.queue_wait_s:
            st.breaches["queue_wait"] += 1
            return ["queue_wait"]
        return []

    def observe_terminal(
        self, tenant: str, state: str, duration_s: float | None
    ) -> list[str]:
        """One terminal transition (done/failed/dead_lettered/terminated).
        Returns the breached kinds (run_duration and/or success_rate)."""
        st = self._stats(tenant)
        st.jobs += 1
        breached: list[str] = []
        cfg = self.config
        if duration_s is not None:
            st.duration_sum_s += max(0.0, duration_s)
            st.duration_max_s = max(st.duration_max_s, duration_s)
            if cfg.run_duration_s and state == "done" and duration_s > cfg.run_duration_s:
                # only successful runs judge duration: a job that died in
                # 2 s must not pass (nor a terminated one fail) the
                # duration SLO
                st.breaches["run_duration"] += 1
                breached.append("run_duration")
        # operator terminations are excluded from the success window: the
        # tenant asked for the kill, the service didn't fail them
        if state != "terminated":
            st.outcomes.append(1 if state == "done" else 0)
            st.completed += 1 if state == "done" else 0
            if cfg.success_rate and len(st.outcomes) >= MIN_OUTCOMES_FOR_RATE:
                rate = sum(st.outcomes) / len(st.outcomes)
                if rate < cfg.success_rate:
                    st.breaches["success_rate"] += 1
                    breached.append("success_rate")
        return breached

    # ------------------------------------------------------------------
    def report(self) -> dict:
        """The ``/v1/slo`` payload: targets + per-tenant observed numbers
        and breach counts."""
        cfg = self.config
        tenants = {}
        for tenant, st in sorted(self._tenants.items()):
            rate = (
                round(sum(st.outcomes) / len(st.outcomes), 4)
                if st.outcomes
                else None
            )
            tenants[tenant] = {
                "queue_wait": {
                    "mean_s": round(st.queue_wait_sum_s / st.dispatches, 3)
                    if st.dispatches
                    else 0.0,
                    "max_s": round(st.queue_wait_max_s, 3),
                    "dispatches": st.dispatches,
                    "breaches": st.breaches["queue_wait"],
                },
                "run_duration": {
                    "mean_s": round(st.duration_sum_s / st.jobs, 3) if st.jobs else 0.0,
                    "max_s": round(st.duration_max_s, 3),
                    "breaches": st.breaches["run_duration"],
                },
                "success_rate": {
                    "rate": rate,
                    "window": len(st.outcomes),
                    "completed": st.completed,
                    "breaches": st.breaches["success_rate"],
                },
                "terminal_jobs": st.jobs,
                "breaches_total": sum(st.breaches.values()),
            }
        return {
            "targets": {
                "queue_wait_s": cfg.queue_wait_s or None,
                "run_duration_s": cfg.run_duration_s or None,
                "success_rate": cfg.success_rate or None,
                "window": cfg.window,
            },
            "enabled": cfg.enabled,
            "tenants": tenants,
        }
