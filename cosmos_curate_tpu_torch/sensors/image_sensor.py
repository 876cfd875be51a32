"""Image sensor: sampled access over timestamped still images (port of
``cosmos_curate_tpu/sensors/image_sensor.py``).

A directory (or explicit list) of image files with a timestamp each, with
the ``start_ns`` / ``end_ns`` / ``sample(spec)`` surface of
``CameraSensor``, so it drops into a ``SensorGroup``. Timestamps come from
an explicit list or from file names (``<anything>_<ns>.<ext>`` or a bare
integer stem).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Generator, Sequence

import numpy as np

from cosmos_curate_tpu_torch.sensors.sampling import SamplingSpec, sample_window_indices
from cosmos_curate_tpu_torch.sensors.validation import require_strictly_increasing

_IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def timestamp_from_name(path: Path) -> int:
    """``frame_0001700000000.jpg`` / ``1700000000.png`` -> ns int."""
    stem = path.stem
    tail = stem.rsplit("_", 1)[-1]
    if not tail.isdigit():
        raise ValueError(f"cannot parse a timestamp from image name {path.name!r}")
    return int(tail)


@dataclass
class ImageData:
    """One sampling window's worth of images."""

    align_timestamps_ns: np.ndarray
    sensor_timestamps_ns: np.ndarray
    paths: list[str]
    frames: np.ndarray  # uint8 [N, H, W, 3] RGB

    def __len__(self) -> int:
        return len(self.sensor_timestamps_ns)


class ImageSensor:
    def __init__(
        self,
        paths: Sequence[str | Path],
        timestamps_ns: Sequence[int] | None = None,
        *,
        resize_hw: tuple[int, int] | None = None,
    ) -> None:
        if not paths:
            raise ValueError("image sensor needs at least one image")
        if timestamps_ns is None:
            timestamps_ns = [timestamp_from_name(Path(p)) for p in paths]
        if len(timestamps_ns) != len(paths):
            raise ValueError(
                f"{len(timestamps_ns)} timestamps for {len(paths)} images"
            )
        order = np.argsort(np.asarray(timestamps_ns, np.int64), kind="stable")
        self._paths = [str(paths[i]) for i in order]
        self._ts_ns = np.asarray(timestamps_ns, np.int64)[order]
        require_strictly_increasing("image timestamps", self._ts_ns)
        self.resize_hw = resize_hw

    @classmethod
    def from_dir(cls, directory: str | Path, **kw) -> "ImageSensor":
        paths = sorted(
            p for p in Path(directory).iterdir() if p.suffix.lower() in _IMAGE_SUFFIXES
        )
        return cls(paths, **kw)

    @property
    def timestamps_ns(self) -> np.ndarray:
        return self._ts_ns

    @property
    def start_ns(self) -> int:
        return int(self._ts_ns[0])

    @property
    def end_ns(self) -> int:
        return int(self._ts_ns[-1])

    def _load(self, idx: int) -> np.ndarray:
        import cv2

        img = cv2.imread(self._paths[idx], cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"unreadable image {self._paths[idx]}")
        if self.resize_hw is not None:
            h, w = self.resize_hw
            img = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def sample(self, spec: SamplingSpec) -> Generator[ImageData, None, None]:
        """One ImageData per window; each selected image is loaded once and
        repeated per its grid-match count (CameraSensor semantics)."""
        for window in spec.grid:
            idx, counts = sample_window_indices(self._ts_ns, window, policy=spec.policy)
            if len(idx) == 0:
                yield ImageData(
                    align_timestamps_ns=window.timestamps_ns,
                    sensor_timestamps_ns=np.zeros(0, np.int64),
                    paths=[],
                    frames=np.zeros((0, 0, 0, 3), np.uint8),
                )
                continue
            unique = np.stack([self._load(int(i)) for i in idx])
            rep = np.repeat(np.arange(len(idx)), counts)
            yield ImageData(
                align_timestamps_ns=window.timestamps_ns,
                sensor_timestamps_ns=np.repeat(self._ts_ns[idx], counts),
                paths=[self._paths[int(idx[j])] for j in rep],
                frames=unique[rep],
            )
