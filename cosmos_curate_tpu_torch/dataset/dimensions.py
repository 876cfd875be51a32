"""Dataset dimension bucketing and path codecs (a copy of
``cosmos_curate_tpu/dataset/dimensions.py``).

Even-rounded resize math, contiguous aspect / resolution / duration range
bins, and the bucket <-> dataset-path codecs the webdataset shards are laid
out by. One generic ``RangeBins`` primitive serves all three binnings; a
bucket's ``key`` and ``path`` round-trip through one regex.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Generic, Sequence, TypeVar

T = TypeVar("T")


def round_to_even(n: float) -> int:
    """Nearest even integer (video codecs require even dimensions). Ties
    round UP, matching the reference (_round_to_nearest_even keeps the floor
    only when strictly closer)."""
    base = int(n) // 2 * 2
    return base if n - base < (base + 2) - n else base + 2


@dataclass(frozen=True)
class Dimensions:
    """Width/height pair with the resize math model stages share."""

    width: int
    height: int

    @property
    def w_by_h(self) -> float:
        return self.width / self.height

    def resize_by_shortest_side(self, short: int) -> "Dimensions":
        """Scale so min(w, h) == short, the long side rounded to even."""
        if short % 2:
            raise ValueError(f"target short side must be even, got {short}")
        if self.height <= self.width:
            return Dimensions(round_to_even(short / self.height * self.width), short)
        return Dimensions(short, round_to_even(short / self.width * self.height))


class RangeBins(Generic[T]):
    """Contiguous half-open value ranges mapping to labels.

    The single primitive behind aspect-ratio, resolution, and duration
    binning; construction validates contiguity so dataset layouts can't
    silently develop gaps. ``closed="right"`` means ``(lo, hi]`` (the
    reference's aspect-bin convention); ``closed="left"`` means
    ``[lo, hi)`` (floor semantics — a 400px-short video is 360p-class)."""

    def __init__(self, edges: Sequence[float], labels: Sequence[T], *, closed: str = "right"):
        if len(edges) != len(labels) + 1:
            raise ValueError(f"{len(labels)} bins need {len(labels) + 1} edges")
        for a, b in zip(edges, edges[1:]):
            if not a < b:
                raise ValueError(f"bin edges must increase: {a} !< {b}")
        if closed not in ("left", "right"):
            raise ValueError(f"closed must be 'left' or 'right', got {closed!r}")
        self.edges = list(edges)
        self.labels = list(labels)
        self.closed = closed

    def find(self, value: float) -> T | None:
        for lo, hi, label in zip(self.edges, self.edges[1:], self.labels):
            hit = lo <= value < hi if self.closed == "left" else lo < value <= hi
            if hit:
                return label
        return None


# Standard bins: the dataset layouts the reference's standard image/video
# datasets use (dimensions.py:212-318,390-470).
ASPECT_BINS: RangeBins[tuple[int, int]] = RangeBins(
    [0.0, 0.65, 0.88, 1.16, 1.55, 10.0],
    [(9, 16), (3, 4), (1, 1), (4, 3), (16, 9)],
)
RESOLUTION_BINS: RangeBins[str] = RangeBins(
    [0, 360, 480, 720, 1080, 2160, float("inf")],
    ["0p", "360p", "480p", "720p", "1080p", "2160p"],
    closed="left",
)
DURATION_BINS: RangeBins[str] = RangeBins(
    [0.0, 2.0, 5.0, 10.0, 30.0, 60.0, float("inf")],
    ["0-2s", "2-5s", "5-10s", "10-30s", "30-60s", "60s-"],
)
FRAME_WINDOWS: list[int] = [256, 128, 64, 32, 16, 0]


@dataclass(frozen=True)
class DimensionBucket:
    """One shard-compatible group: aspect x resolution x frame window,
    optionally a duration band."""

    aspect: str  # "16-9"
    resolution: str  # "720p"
    frame_window: int
    duration: str | None = None

    @property
    def key(self) -> str:
        base = f"{self.aspect}_{self.resolution}_w{self.frame_window}"
        return f"{base}_d{self.duration}" if self.duration else base

    # -- dataset path codec (reference to_path_string/from_path_string) ---
    @property
    def path(self) -> str:
        parts = [
            f"resolution_{self.resolution}",
            f"aspect_ratio_{self.aspect.replace('-', '_')}",
            f"frames_{self.frame_window}",
        ]
        if self.duration:
            parts.append(f"duration_{self.duration}")
        return "/".join(parts)

    _PATH_RE = re.compile(
        r"resolution_(?P<res>[0-9]+p)/aspect_ratio_(?P<aw>\d+)_(?P<ah>\d+)"
        r"/frames_(?P<fw>\d+)(?:/duration_(?P<dur>[^/]+))?"
    )

    @classmethod
    def from_path(cls, path: str) -> "DimensionBucket":
        m = cls._PATH_RE.search(path)
        if m is None:
            raise ValueError(f"not a dimension path: {path!r}")
        return cls(
            aspect=f"{m.group('aw')}-{m.group('ah')}",
            resolution=m.group("res"),
            frame_window=int(m.group("fw")),
            duration=m.group("dur"),
        )


def bucket_for(
    width: int,
    height: int,
    num_frames: int,
    *,
    duration_s: float | None = None,
) -> DimensionBucket:
    """Classify a clip into its shard bucket. Out-of-range (degenerate)
    inputs land in the smallest bucket rather than raising — a single bad
    probe must not kill a sharding run."""
    if width <= 0 or height <= 0:
        return DimensionBucket("1-1", "0p", 0)
    ar = ASPECT_BINS.find(width / height) or (16, 9)
    aspect = f"{ar[0]}-{ar[1]}"
    resolution = RESOLUTION_BINS.find(min(width, height)) or "0p"
    window = next(w for w in FRAME_WINDOWS if num_frames >= w)
    duration = DURATION_BINS.find(duration_s) if duration_s is not None else None
    return DimensionBucket(aspect, resolution, window, duration)
