"""Chaos fault injection for the runners, the retry policy, the cross-node
plane and the job service (port of ``cosmos_curate_tpu/chaos``).

Every failure mode the runners must survive has a *named injection site*,
one ``fire()`` call in production code, and a :class:`FaultPlan` arms a
subset of those sites with deterministic, seeded faults. Disabled is the
default and costs one falsy module-attribute check per site.
"""

from cosmos_curate_tpu_torch.chaos.harness import (
    ALL_SITES,
    CHAOS_ENV,
    SITE_AGENT_KILL,
    SITE_AGENT_PARTITION,
    SITE_OBJECT_CHANNEL_FETCH,
    SITE_OBJECT_CHANNEL_SERVE,
    SITE_REMOTE_PLANE_RECV,
    SITE_REMOTE_PLANE_SEND,
    SITE_SERVICE_JOB_CRASH,
    SITE_SERVICE_JOURNAL_WRITE,
    SITE_STORAGE_REQUEST,
    SITE_WORKER_CRASH,
    SITE_WORKER_HANG,
    FaultPlan,
    FaultRule,
    InjectedFault,
    enabled,
    fire,
    fire_count,
    install,
    install_from_env,
    uninstall,
)

__all__ = [
    "ALL_SITES",
    "CHAOS_ENV",
    "SITE_AGENT_KILL",
    "SITE_AGENT_PARTITION",
    "SITE_OBJECT_CHANNEL_FETCH",
    "SITE_OBJECT_CHANNEL_SERVE",
    "SITE_REMOTE_PLANE_RECV",
    "SITE_REMOTE_PLANE_SEND",
    "SITE_SERVICE_JOB_CRASH",
    "SITE_SERVICE_JOURNAL_WRITE",
    "SITE_STORAGE_REQUEST",
    "SITE_WORKER_CRASH",
    "SITE_WORKER_HANG",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "enabled",
    "fire",
    "fire_count",
    "install",
    "install_from_env",
    "uninstall",
]
