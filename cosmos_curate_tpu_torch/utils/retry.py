"""Retry decorator with exponential backoff (port of
``cosmos_curate_tpu/utils/retry.py``)."""

from __future__ import annotations

import functools
import time
from typing import Callable, TypeVar

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

T = TypeVar("T")


def retry(
    attempts: int = 3,
    backoff_s: float = 1.0,
    exceptions: tuple[type[BaseException], ...] = (Exception,),
):
    """Retry the decorated function on ``exceptions``, sleeping
    ``backoff_s * 2**i`` after the i-th failure; the last failure raises."""

    def deco(fn: Callable[..., T]) -> Callable[..., T]:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs) -> T:
            last: BaseException | None = None
            for i in range(max(1, attempts)):
                try:
                    return fn(*args, **kwargs)
                except exceptions as e:
                    last = e
                    if i + 1 < attempts:
                        wait = backoff_s * (2**i)
                        logger.warning("%s failed (attempt %d/%d): %s; retrying in %.1fs",
                                       fn.__name__, i + 1, attempts, e, wait)
                        time.sleep(wait)
            raise last  # type: ignore[misc]

        return wrapper

    return deco
