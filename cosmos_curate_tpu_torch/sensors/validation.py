"""Array validation helpers for sensor data (port of
``cosmos_curate_tpu/sensors/validation.py``).

Dtype, shape, monotonicity and finiteness checks applied when a sensor is
built, so malformed capture data raises a clear ``ValueError`` at load
rather than misaligning samples later.
"""

from __future__ import annotations

import numpy as np


def require_1d(name: str, values: np.ndarray, dtype: type | None = None) -> np.ndarray:
    arr = np.asarray(values)
    if arr.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got shape {arr.shape}")
    if dtype is not None and arr.dtype != np.dtype(dtype):
        raise ValueError(f"{name} must have dtype {np.dtype(dtype)}, got {arr.dtype}")
    return arr


def require_finite(name: str, values: np.ndarray) -> np.ndarray:
    arr = np.asarray(values)
    if not np.isfinite(arr).all():
        bad = int(np.size(arr) - np.isfinite(arr).sum())
        raise ValueError(f"{name} contains {bad} non-finite values")
    return arr


def require_strictly_increasing(name: str, values: np.ndarray) -> np.ndarray:
    arr = np.asarray(values)
    if len(arr) > 1 and not (np.diff(arr) > 0).all():
        i = int(np.argmin(np.diff(arr)))
        raise ValueError(
            f"{name} must be strictly increasing; violation at index {i}: "
            f"{arr[i]} -> {arr[i + 1]}"
        )
    return arr


def require_nondecreasing(name: str, values: np.ndarray) -> np.ndarray:
    arr = np.asarray(values)
    if len(arr) > 1 and not (np.diff(arr) >= 0).all():
        i = int(np.argmin(np.diff(arr)))
        raise ValueError(
            f"{name} must be non-decreasing; violation at index {i}: "
            f"{arr[i]} -> {arr[i + 1]}"
        )
    return arr


def strictly_increasing_int64(name: str, values) -> np.ndarray:
    """Canonical timestamp-array constructor: 1-D int64, strictly increasing."""
    arr = np.asarray(values, np.int64)
    require_1d(name, arr, np.int64)
    require_strictly_increasing(name, arr)
    return arr
