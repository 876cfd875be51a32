"""Timestamp sampling: nanosecond grids, windows and policies (port of
``cosmos_curate_tpu/sensors/sampling.py``).

A strictly ascending int64 nanosecond grid at a sample rate, iterated as
half-open ``[start, exclusive_end)`` windows; each grid point is matched to
the nearest canonical sensor timestamp under a tolerance policy. The grid
always holds ``start_ns``; an inclusive ``end_ns`` stays reachable because
one sample past it is kept as the exclusive boundary marker.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator

import numpy as np

NS = 1_000_000_000


def make_ts_grid(
    start_ns: int,
    end_ns: int | None = None,
    sample_rate_hz: float | None = None,
    *,
    exclusive_end_ns: int | None = None,
) -> tuple[int, int, np.ndarray]:
    """-> (start_ns, exclusive_end_ns, timestamps_ns[int64, read-only]).

    Exactly one of ``end_ns`` (inclusive) / ``exclusive_end_ns`` (half-open)
    must be given; see module docstring for the boundary semantics."""
    if sample_rate_hz is None or sample_rate_hz <= 0:
        raise ValueError(f"sample_rate_hz must be > 0, got {sample_rate_hz}")
    if (end_ns is None) == (exclusive_end_ns is None):
        raise ValueError("exactly one of end_ns / exclusive_end_ns required")
    if exclusive_end_ns is not None:
        if exclusive_end_ns <= start_ns:
            raise ValueError(f"exclusive_end_ns {exclusive_end_ns} <= start_ns {start_ns}")
        bound_ns = exclusive_end_ns - 1
    else:
        if end_ns < start_ns:
            raise ValueError(f"end_ns {end_ns} < start_ns {start_ns}")
        bound_ns = end_ns

    step_s = 1.0 / sample_rate_hz
    span_steps = (bound_ns - start_ns) / NS / step_s
    # enough samples that the last one lands strictly past the bound (it
    # becomes the exclusive-end marker), robust to float roundoff at exact
    # multiples
    n = max(2, math.floor(np.nextafter(span_steps, np.inf)) + 2)
    ts = np.round((start_ns / NS + np.arange(n) * step_s) * NS).astype(np.int64)
    if np.any(np.diff(ts) <= 0):
        raise ValueError(
            f"sample_rate_hz={sample_rate_hz} rounds to a non-increasing ns grid"
        )
    grid = ts[:-1]
    grid.flags.writeable = False
    out_excl = exclusive_end_ns if exclusive_end_ns is not None else int(ts[-1])
    return int(ts[0]), out_excl, grid


@dataclass(frozen=True)
class SamplingWindow:
    """One half-open batch of grid timestamps: every reference timestamp
    strictly below ``exclusive_end_ns`` belongs to this window."""

    timestamps_ns: np.ndarray
    exclusive_end_ns: int

    def __len__(self) -> int:
        return len(self.timestamps_ns)


@dataclass(frozen=True)
class SamplingGrid:
    """A ts grid chunked into fixed-size windows for batched decoding."""

    start_ns: int
    exclusive_end_ns: int
    timestamps_ns: np.ndarray
    window_size: int = 64

    @classmethod
    def from_rate(
        cls,
        start_ns: int,
        *,
        sample_rate_hz: float,
        end_ns: int | None = None,
        exclusive_end_ns: int | None = None,
        window_size: int = 64,
    ) -> "SamplingGrid":
        s, e, ts = make_ts_grid(
            start_ns, end_ns, sample_rate_hz, exclusive_end_ns=exclusive_end_ns
        )
        return cls(s, e, ts, window_size)

    def __iter__(self) -> Iterator[SamplingWindow]:
        n = len(self.timestamps_ns)
        for i in range(0, max(n, 1), self.window_size):
            chunk = self.timestamps_ns[i : i + self.window_size]
            if i + self.window_size >= n:
                end = self.exclusive_end_ns
            else:
                end = int(self.timestamps_ns[i + self.window_size])
            yield SamplingWindow(chunk, end)

    def __len__(self) -> int:
        n = len(self.timestamps_ns)
        return max(1, -(-n // self.window_size))


@dataclass(frozen=True)
class SamplingPolicy:
    """tolerance_ns = max |grid point - chosen canonical timestamp|; grid
    points with no canonical sample inside the tolerance are dropped."""

    tolerance_ns: int = 0

    def __post_init__(self) -> None:
        if self.tolerance_ns < 0:
            raise ValueError("tolerance_ns must be >= 0")


@dataclass(frozen=True)
class SamplingSpec:
    grid: SamplingGrid
    policy: SamplingPolicy | None = None


def find_closest_indices(canonical: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """For each grid timestamp, the index of the nearest canonical
    timestamp (canonical must be sorted ascending)."""
    canonical = np.asarray(canonical, np.int64)
    grid = np.asarray(grid, np.int64)
    pos = np.searchsorted(canonical, grid)
    pos = np.clip(pos, 1, len(canonical) - 1) if len(canonical) > 1 else np.zeros_like(pos)
    left = canonical[pos - 1] if len(canonical) > 1 else canonical[pos]
    right = canonical[pos]
    choose_left = (grid - left) <= (right - grid)
    return np.where(choose_left, pos - 1, pos) if len(canonical) > 1 else pos


def sample_window_indices(
    canonical: np.ndarray,
    window: SamplingWindow,
    *,
    policy: SamplingPolicy | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """-> (unique canonical indices, per-index repeat counts) for a window.

    A canonical frame matched by several grid points is decoded once and
    repeated (counts)."""
    if len(window) == 0 or len(canonical) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    idx = find_closest_indices(canonical, window.timestamps_ns)
    if policy is not None:
        delta = np.abs(np.asarray(canonical, np.int64)[idx] - window.timestamps_ns)
        idx = idx[delta <= policy.tolerance_ns]  # 0 = exact matches only
    if len(idx) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    uniq, counts = np.unique(idx, return_counts=True)
    return uniq.astype(np.int64), counts.astype(np.int64)
