"""Fault-plan model and the per-process injection runtime (port of
``cosmos_curate_tpu/chaos/harness.py``: the worker-batch sites the runners
fire, the ``storage.request`` site of ``storage/retry.py``, the sites of
the cross-node plane: the object channel, the control link and the node
agents, and the job service's: a job child's start and the journal's
append).

- **No-op when disabled.** ``fire(site)`` is the only call on the hot path;
  while no plan is installed it is a single falsy check on a module global.
- **Deterministic.** Each armed rule owns a ``random.Random`` seeded from
  ``(plan.seed, site)``, so a plan gives the same fire/skip sequence on
  every run.
- **Cross-process.** Plans serialize to JSON and ride the ``CURATE_CHAOS``
  environment variable into spawned workers (engine/pool.py forwards it)
  and node agents; each process arms its own counters, so ``count`` bounds
  firings *per process*, and ``worker_re`` limits a rule to the processes
  whose ``CURATE_WORKER_ID`` it matches.

Fault kinds:

- ``crash``: ``os._exit(exit_code)``, a worker death with no exception;
- ``hang``: ``time.sleep(delay_s)``, a stuck-decoder stand-in;
- ``error``: raise :class:`InjectedFault` (a ``ConnectionError``);
- ``delay``: ``time.sleep(delay_s)`` then continue.

"""

from __future__ import annotations

import json
import os
import random
import re
import threading
import time
from dataclasses import dataclass

CHAOS_ENV = "CURATE_CHAOS"

SITE_WORKER_CRASH = "worker.batch.crash"
SITE_WORKER_HANG = "worker.batch.hang"
SITE_OBJECT_CHANNEL_FETCH = "object_channel.fetch"
SITE_OBJECT_CHANNEL_SERVE = "object_channel.serve"
SITE_REMOTE_PLANE_SEND = "remote_plane.send"
SITE_REMOTE_PLANE_RECV = "remote_plane.recv"
SITE_STORAGE_REQUEST = "storage.request"
# the job service (service/app.py + service/job_queue.py): a job child
# dying at startup (a crash rule rides CURATE_CHAOS into the child; pair it
# with ``worker_re`` against the stamped CURATE_WORKER_ID=job-<id>-a<attempt>
# to fault only the first attempt), and the journal's append failing
SITE_SERVICE_JOB_CRASH = "service.job.crash"
SITE_SERVICE_JOURNAL_WRITE = "service.journal.write"
# node loss (engine/remote_agent.py): agent.kill fires in the agent right
# after it relays a result (kind=crash: the node dies holding outputs the
# driver already references); agent.partition fires on every frame in both
# directions (kind=hang stalls frames until the driver declares the node
# dead). Pin a rule to one agent of a fleet with ``worker_re`` against the
# CURATE_WORKER_ID in that agent's environment.
SITE_AGENT_KILL = "agent.kill"
SITE_AGENT_PARTITION = "agent.partition"

ALL_SITES = (
    SITE_WORKER_CRASH,
    SITE_WORKER_HANG,
    SITE_OBJECT_CHANNEL_FETCH,
    SITE_OBJECT_CHANNEL_SERVE,
    SITE_REMOTE_PLANE_SEND,
    SITE_REMOTE_PLANE_RECV,
    SITE_STORAGE_REQUEST,
    SITE_SERVICE_JOB_CRASH,
    SITE_SERVICE_JOURNAL_WRITE,
    SITE_AGENT_KILL,
    SITE_AGENT_PARTITION,
)

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
    # only fire in processes whose CURATE_WORKER_ID matches ('' = all)
    worker_re: str = ""

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

    def to_json(self) -> str:
        rules = [{"site": r.site, "kind": r.kind, "probability": r.probability, "count": r.count,
                  "delay_s": r.delay_s, "exit_code": r.exit_code, "worker_re": r.worker_re} for r in self.rules]
        return json.dumps({"seed": self.seed, "rules": rules})

    @classmethod
    def from_json(cls, text: str) -> FaultPlan:
        doc = json.loads(text)
        return cls(seed=int(doc.get("seed", 0)), rules=tuple(FaultRule(**r) for r in doc.get("rules", ())))


class _ArmedRule:
    """Per-process mutable state for one rule (RNG + remaining budget)."""

    def __init__(self, rule: FaultRule, seed: int) -> None:
        self.rule = rule
        self.rng = random.Random(f"{seed}:{rule.site}")
        self.remaining = rule.count  # None = unlimited
        self.fired = 0
        self.lock = threading.Lock()
        self.worker_pat = re.compile(rule.worker_re) if rule.worker_re else None

    def should_fire(self) -> bool:
        if self.worker_pat is not None and not self.worker_pat.search(os.environ.get("CURATE_WORKER_ID", "")):
            return False
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


def install(plan: FaultPlan, *, export_env: bool = False) -> None:
    """Arm ``plan`` in this process. ``export_env=True`` also writes it to
    ``CURATE_CHAOS``, so processes spawned after this call arm it too."""
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
    if export_env:
        os.environ[CHAOS_ENV] = plan.to_json()


def uninstall() -> None:
    """Disarm; also clears ``CURATE_CHAOS`` from this environment."""
    global _active
    _active = None
    os.environ.pop(CHAOS_ENV, None)


def install_from_env() -> bool:
    """Arm from ``CURATE_CHAOS`` if present; True when a plan was armed.
    Called once at process bring-up (``worker_main``, the agent's main)."""
    text = os.environ.get(CHAOS_ENV, "")
    if not text:
        return False
    install(FaultPlan.from_json(text))
    return True
