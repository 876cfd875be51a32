"""Chaos fault injection for the runners (port of
``cosmos_curate_tpu/chaos``, the sites the in-process runners fire).

Every failure mode the runners must survive has a *named injection site*,
one ``fire()`` call in production code, and a :class:`FaultPlan` arms a
subset of those sites with deterministic, seeded faults. Disabled is the
default and costs one falsy module-attribute check per site.
"""

from cosmos_curate_tpu_torch.chaos.harness import (
    ALL_SITES,
    SITE_WORKER_CRASH,
    SITE_WORKER_HANG,
    FaultPlan,
    FaultRule,
    InjectedFault,
    enabled,
    fire,
    fire_count,
    install,
    uninstall,
)

__all__ = [
    "ALL_SITES",
    "SITE_WORKER_CRASH",
    "SITE_WORKER_HANG",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "enabled",
    "fire",
    "fire_count",
    "install",
    "uninstall",
]
