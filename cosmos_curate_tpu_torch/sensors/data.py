"""Multi-sensor data model for AV capture sessions (port of
``cosmos_curate_tpu/sensors/data.py``).

Camera intrinsics and extrinsics, camera frame references, GPS and IMU
samples, aligned frames and sessions, and the JSONL session log reader
(one record per line, with a ``type`` field).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass(frozen=True)
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    distortion: tuple[float, ...] = ()

    def matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float64
        )


@dataclass(frozen=True)
class CameraExtrinsics:
    """Sensor-to-vehicle transform."""

    rotation: tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)  # wxyz quat
    translation: tuple[float, float, float] = (0.0, 0.0, 0.0)

    def matrix(self) -> np.ndarray:
        w, x, y, z = self.rotation
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = self.translation
        return T


@dataclass(frozen=True)
class CameraFrameRef:
    """Reference to one camera frame: video + index + timestamp."""

    camera: str
    video_path: str
    frame_index: int
    timestamp_s: float


@dataclass(frozen=True)
class GpsSample:
    timestamp_s: float
    latitude: float
    longitude: float
    altitude_m: float = 0.0
    speed_mps: float = 0.0


@dataclass(frozen=True)
class ImuSample:
    timestamp_s: float
    accel: tuple[float, float, float]
    gyro: tuple[float, float, float]


@dataclass
class AlignedFrame:
    """One time-aligned multi-sensor snapshot."""

    timestamp_s: float
    cameras: dict[str, CameraFrameRef] = field(default_factory=dict)
    gps: GpsSample | None = None
    imu: ImuSample | None = None


@dataclass
class SensorSession:
    session_id: str
    cameras: dict[str, list[CameraFrameRef]] = field(default_factory=dict)
    gps: list[GpsSample] = field(default_factory=list)
    imu: list[ImuSample] = field(default_factory=list)
    intrinsics: dict[str, CameraIntrinsics] = field(default_factory=dict)
    extrinsics: dict[str, CameraExtrinsics] = field(default_factory=dict)


def load_session_jsonl(path: str | Path) -> SensorSession:
    """Read a session log: one JSON record per line with a ``type`` field
    (camera_frame | gps | imu | intrinsics | extrinsics)."""
    session = SensorSession(session_id=Path(path).stem)
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        rec = json.loads(line)
        kind = rec.pop("type")
        if kind == "camera_frame":
            session.cameras.setdefault(rec["camera"], []).append(CameraFrameRef(**rec))
        elif kind == "gps":
            session.gps.append(GpsSample(**rec))
        elif kind == "imu":
            session.imu.append(
                ImuSample(rec["timestamp_s"], tuple(rec["accel"]), tuple(rec["gyro"]))
            )
        elif kind == "intrinsics":
            cam = rec.pop("camera")
            session.intrinsics[cam] = CameraIntrinsics(**rec)
        elif kind == "extrinsics":
            cam = rec.pop("camera")
            session.extrinsics[cam] = CameraExtrinsics(
                tuple(rec["rotation"]), tuple(rec["translation"])
            )
    return session
