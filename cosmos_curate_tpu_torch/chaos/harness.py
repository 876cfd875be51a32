"""Fault-plan model and the per-process injection runtime (port of
``cosmos_curate_tpu/chaos/harness.py``: the worker-batch sites that
``SequentialRunner`` and ``PipelinedRunner`` fire, and the
``storage.request`` site of ``storage/retry.py``).

- **No-op when disabled.** ``fire(site)`` is the only call on the hot path;
  while no plan is installed it is a single falsy check on a module global.
- **Deterministic.** Each armed rule owns a ``random.Random`` seeded from
  ``(plan.seed, site)``, so a plan gives the same fire/skip sequence on
  every run.

Fault kinds:

- ``crash``: ``os._exit(exit_code)``, a worker death with no exception;
- ``hang``: ``time.sleep(delay_s)``, a stuck-decoder stand-in;
- ``error``: raise :class:`InjectedFault` (a ``ConnectionError``);
- ``delay``: ``time.sleep(delay_s)`` then continue.

Not ported: the sites of the streaming engine, the object and remote
planes, the job service and node agents, the ``CURATE_CHAOS``
environment hand-off to worker processes and the per-worker filter
(``worker_re``); the port has none of those layers yet.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass

SITE_WORKER_CRASH = "worker.batch.crash"
SITE_WORKER_HANG = "worker.batch.hang"
SITE_STORAGE_REQUEST = "storage.request"

ALL_SITES = (SITE_WORKER_CRASH, SITE_WORKER_HANG, SITE_STORAGE_REQUEST)

_KINDS = ("crash", "hang", "error", "delay")


class InjectedFault(ConnectionError):
    """Raised by ``error``-kind rules."""

    def __init__(self, site: str) -> None:
        super().__init__(f"chaos: injected fault at {site}")
        self.site = site


@dataclass(frozen=True)
class FaultRule:
    """Arm one site: fire with ``probability`` up to ``count`` times."""

    site: str
    kind: str = "error"
    probability: float = 1.0
    count: int | None = None  # max firings in this process; None = unlimited
    delay_s: float = 0.0  # hang/delay duration
    exit_code: int = 17  # crash exit code (distinguishable from real deaths)

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {_KINDS}")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"probability must be in [0, 1], got {self.probability}")
        if self.count is not None and self.count < 0:
            raise ValueError(f"count must be >= 0, got {self.count}")


@dataclass(frozen=True)
class FaultPlan:
    """A set of armed rules plus the seed that makes them deterministic."""

    rules: tuple[FaultRule, ...] = ()
    seed: int = 0


class _ArmedRule:
    """Per-process mutable state for one rule (RNG + remaining budget)."""

    def __init__(self, rule: FaultRule, seed: int) -> None:
        self.rule = rule
        self.rng = random.Random(f"{seed}:{rule.site}")
        self.remaining = rule.count  # None = unlimited
        self.fired = 0
        self.lock = threading.Lock()

    def should_fire(self) -> bool:
        with self.lock:
            if self.remaining is not None and self.remaining <= 0:
                return False
            if self.rule.probability < 1.0 and self.rng.random() >= self.rule.probability:
                return False
            if self.remaining is not None:
                self.remaining -= 1
            self.fired += 1
            return True


class _ActivePlan:
    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.by_site = {r.site: _ArmedRule(r, plan.seed) for r in plan.rules}

    def fire(self, site: str) -> None:
        armed = self.by_site.get(site)
        if armed is None or not armed.should_fire():
            return
        rule = armed.rule
        if rule.kind == "crash":
            os._exit(rule.exit_code)
        if rule.kind in ("hang", "delay"):
            time.sleep(rule.delay_s)
            return
        raise InjectedFault(site)


# None while chaos is disabled: fire() below is the only thing production
# code calls, and its disabled cost is one falsy check
_active: _ActivePlan | None = None


def fire(site: str) -> None:
    """Injection-site entry point; a no-op unless a plan arms ``site``."""
    active = _active
    if active is None:
        return
    active.fire(site)


def enabled() -> bool:
    return _active is not None


def fire_count(site: str) -> int:
    """How many times ``site`` has fired in this process."""
    active = _active
    if active is None:
        return 0
    armed = active.by_site.get(site)
    return armed.fired if armed is not None else 0


def install(plan: FaultPlan) -> None:
    """Arm ``plan`` in this process."""
    global _active
    unknown = [r.site for r in plan.rules if r.site not in ALL_SITES]
    if unknown:
        raise ValueError(f"unknown chaos site(s): {unknown}; known: {list(ALL_SITES)}")
    sites = [r.site for r in plan.rules]
    dupes = sorted({s for s in sites if sites.count(s) > 1})
    if dupes:
        # one armed rule per site: silently keeping only the last rule
        # would make a chaos test exercise less than it claims
        raise ValueError(f"duplicate rule(s) for site(s): {dupes}")
    _active = _ActivePlan(plan)


def uninstall() -> None:
    """Disarm."""
    global _active
    _active = None
