"""Shared HTTP retry policy (port of ``cosmos_curate_tpu/storage/retry.py``).

The backoff schedule and the retryable-status set for every HTTP client of
the port: today the image API caption stage
(``pipelines/image/api_caption.py``); the remote storage backends that the
reference built it for come with ROADMAP queue A item 10.

Backoff is exponential with **full jitter**: ``sleep ~ U(0, min(cap, base *
2**attempt))``, so a fleet of workers that all saw the same outage does not
retry in lockstep.

Not ported: ``sleep_backoff``'s annotation of the enclosing ``storage.*``
trace span with the retry count and summed backoff, which waits for the
port's tracing (ROADMAP queue A item 14). The chaos harness's
``storage.request`` site is :func:`chaos_storage_fault`.
"""

from __future__ import annotations

import random
import time

from cosmos_curate_tpu_torch import chaos

# 429 (throttling) and the transient 5xx family. 501/505 etc. are
# deterministic and excluded: retrying them only delays the error.
RETRYABLE_STATUSES = frozenset({429, 500, 502, 503, 504})

DEFAULT_BASE_S = 0.2
DEFAULT_CAP_S = 5.0


def is_retryable_status(status: int) -> bool:
    return status in RETRYABLE_STATUSES


def backoff_s(
    attempt: int,
    *,
    base: float = DEFAULT_BASE_S,
    cap: float = DEFAULT_CAP_S,
    rng: random.Random | None = None,
) -> float:
    """Full-jitter backoff for the ``attempt``-th failure (0-based)."""
    ceiling = min(cap, base * (2.0**attempt))
    return (rng or random).uniform(0.0, ceiling)


def sleep_backoff(
    attempt: int,
    *,
    base: float = DEFAULT_BASE_S,
    cap: float = DEFAULT_CAP_S,
    rng: random.Random | None = None,
) -> float:
    """Sleep the jittered backoff; returns the slept duration (for logs)."""
    d = backoff_s(attempt, base=base, cap=cap, rng=rng)
    time.sleep(d)
    return d


def chaos_storage_fault() -> None:
    """The HTTP clients' shared injection site: an armed ``storage.request``
    rule raises :class:`~cosmos_curate_tpu_torch.chaos.InjectedFault` (a
    ``ConnectionError``), which the callers' attempt loops treat like a real
    network failure: retried with backoff, surfaced after the budget."""
    chaos.fire(chaos.SITE_STORAGE_REQUEST)
