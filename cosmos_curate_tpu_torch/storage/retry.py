"""Shared HTTP retry policy (port of ``cosmos_curate_tpu/storage/retry.py``).

The backoff schedule and the retryable-status set for every HTTP client of
the port: the S3, Azure and GCS REST backends (``s3_rest.py``,
``azure_rest.py``, ``gcs_rest.py``), the zip transport
(``zip_transport.py``) and the image API caption stage
(``pipelines/image/api_caption.py``). The three backends share one attempt
loop, :func:`urlopen_with_retries`, which calls :func:`chaos_storage_fault`
before every attempt and :func:`sleep_backoff` after every retried failure.

Backoff is exponential with **full jitter**: ``sleep ~ U(0, min(cap, base *
2**attempt))``, so a fleet of workers that all saw the same outage does not
retry in lockstep.

``sleep_backoff`` annotates the enclosing ``storage.*`` trace span with the
retry count and the summed backoff. The chaos harness's ``storage.request``
site is :func:`chaos_storage_fault`.
"""

from __future__ import annotations

import random
import time
import urllib.error
import urllib.request

from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.observability.tracing import current_span

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
    """Sleep the jittered backoff; returns the slept duration (for logs).

    It also annotates the enclosing ``storage.*`` span with the retry count
    and the summed backoff, so a slow storage span reads as retries or as a
    slow backend. Other callers' spans (the API caption stage's) are left
    alone: retry attributes there would misattribute the wait."""
    d = backoff_s(attempt, base=base, cap=cap, rng=rng)
    span = current_span()
    if span is not None and span.name.startswith("storage."):
        span.set_attribute("attempt", attempt + 2)  # the one about to run
        span.set_attribute("backoff_s", round(float(span.attributes.get("backoff_s", 0.0)) + d, 4))
    time.sleep(d)
    return d


def chaos_storage_fault() -> None:
    """The HTTP clients' shared injection site: an armed ``storage.request``
    rule raises :class:`~cosmos_curate_tpu_torch.chaos.InjectedFault` (a
    ``ConnectionError``), which the callers' attempt loops treat like a real
    network failure: retried with backoff, surfaced after the budget."""
    chaos.fire(chaos.SITE_STORAGE_REQUEST)


def urlopen_with_retries(
    url: str,
    *,
    method: str,
    data: bytes | None,
    headers: dict[str, str],
    retries: int,
    retryable: bool = True,
    label: str,
) -> tuple[int, bytes, dict[str, str]]:
    """(status, body, headers) of one HTTP request, retried with backoff on
    the retryable statuses and on connection failures while ``retryable``
    and attempts remain. Any other HTTP status is returned, not raised: the
    backends map 404 to ``FileNotFoundError`` and the rest to their own
    error. A connection failure on the last attempt raises."""
    last: Exception | None = None
    for attempt in range(retries):
        req = urllib.request.Request(url, data=data, method=method)
        for k, v in headers.items():
            req.add_header(k, v)
        try:
            chaos_storage_fault()
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as e:
            body = e.read()
            if not (is_retryable_status(e.code) and retryable and attempt + 1 < retries):
                return e.code, body, dict(e.headers or {})
            last = e
        except (urllib.error.URLError, ConnectionError, TimeoutError) as e:
            if not retryable or attempt + 1 == retries:
                raise
            last = e
        sleep_backoff(attempt)
    raise RuntimeError(f"{label} exhausted retries: {last}")
