"""Camera sensor: sampled, batched frame access over videos and timestamps
(port of ``cosmos_curate_tpu/sensors/camera_sensor.py``).

``sample(spec)`` yields one ``CameraData`` batch per sampling window; each
selected source frame is decoded once (``video.decode.decode_frame_ids``)
and repeated by its grid-match count. Frames are ``np.uint8`` RGB and
timestamps ``np.int64`` nanoseconds, on the host: a consumer that wants
them on the card moves them itself.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Generator, Sequence

import numpy as np

from cosmos_curate_tpu_torch.sensors.data import (
    CameraExtrinsics,
    CameraFrameRef,
    CameraIntrinsics,
    SensorSession,
)
from cosmos_curate_tpu_torch.sensors.sampling import NS, SamplingSpec, sample_window_indices


@dataclass
class CameraData:
    """One sampling window's worth of frames from one camera."""

    align_timestamps_ns: np.ndarray  # the window's grid points
    sensor_timestamps_ns: np.ndarray  # chosen frame timestamps (repeated)
    frame_indices: np.ndarray  # source frame index per sample (repeated)
    frames: np.ndarray  # uint8 [N, H, W, 3] RGB (repeated per counts)
    camera: str = ""
    intrinsics: CameraIntrinsics | None = None
    extrinsics: CameraExtrinsics | None = None

    def __len__(self) -> int:
        return len(self.sensor_timestamps_ns)


class CameraSensor:
    """One camera of a capture session, sampled on nanosecond grids."""

    def __init__(
        self,
        camera: str,
        frames: Sequence[CameraFrameRef],
        *,
        intrinsics: CameraIntrinsics | None = None,
        extrinsics: CameraExtrinsics | None = None,
        resize_hw: tuple[int, int] | None = None,
    ) -> None:
        if not frames:
            raise ValueError(f"camera {camera!r} has no frames")
        self.camera = camera
        self.frames = sorted(frames, key=lambda f: f.timestamp_s)
        self.intrinsics = intrinsics
        self.extrinsics = extrinsics
        self.resize_hw = resize_hw
        from cosmos_curate_tpu_torch.sensors.validation import strictly_increasing_int64

        # duplicate or backward timestamps raise here, not as a misalignment later
        self._ts_ns = strictly_increasing_int64(
            f"camera {camera!r} timestamps",
            [round(f.timestamp_s * NS) for f in self.frames],
        )

    @classmethod
    def from_session(
        cls, session: SensorSession, camera: str, **kw
    ) -> "CameraSensor":
        return cls(
            camera,
            session.cameras.get(camera, []),
            intrinsics=session.intrinsics.get(camera),
            extrinsics=session.extrinsics.get(camera),
            **kw,
        )

    # -- index properties ------------------------------------------------
    @property
    def timestamps_ns(self) -> np.ndarray:
        return self._ts_ns

    @property
    def start_ns(self) -> int:
        return int(self._ts_ns[0])

    @property
    def end_ns(self) -> int:
        return int(self._ts_ns[-1])

    @property
    def max_gap_ns(self) -> int:
        if len(self._ts_ns) < 2:
            return 0
        return int(np.diff(self._ts_ns).max())

    # -- sampling ----------------------------------------------------------
    def sample(self, spec: SamplingSpec) -> Generator[CameraData, None, None]:
        """One CameraData per sampling window (empty windows yield empty
        batches so batch i always corresponds to window i). Each selected
        source frame is decoded once and repeated per its match count."""
        from cosmos_curate_tpu_torch.video.decode import decode_frame_ids

        for window in spec.grid:
            idx, counts = sample_window_indices(self._ts_ns, window, policy=spec.policy)
            if len(idx) == 0:
                yield CameraData(
                    align_timestamps_ns=window.timestamps_ns,
                    sensor_timestamps_ns=np.zeros(0, np.int64),
                    frame_indices=np.zeros(0, np.int64),
                    frames=np.zeros((0, 0, 0, 3), np.uint8),
                    camera=self.camera,
                    intrinsics=self.intrinsics,
                    extrinsics=self.extrinsics,
                )
                continue
            # group by source video (a camera may span several files)
            refs = [self.frames[i] for i in idx]
            decoded: dict[int, np.ndarray] = {}
            by_video: dict[str, list[int]] = {}
            for j, r in enumerate(refs):
                by_video.setdefault(r.video_path, []).append(j)
            for video, positions in by_video.items():
                # decode_frame_ids returns frames in sorted-id order
                positions = sorted(positions, key=lambda j: refs[j].frame_index)
                frame_ids = [refs[j].frame_index for j in positions]
                frames = decode_frame_ids(video, frame_ids, resize_hw=self.resize_hw)
                for j, fr in zip(positions, frames):
                    decoded[j] = fr
            stacked = np.stack([decoded[j] for j in range(len(refs))])
            rep = np.repeat(np.arange(len(refs)), counts)
            yield CameraData(
                align_timestamps_ns=window.timestamps_ns,
                sensor_timestamps_ns=np.repeat(self._ts_ns[idx], counts),
                frame_indices=np.repeat(
                    np.asarray([r.frame_index for r in refs], np.int64), counts
                ),
                frames=stacked[rep],
                camera=self.camera,
                intrinsics=self.intrinsics,
                extrinsics=self.extrinsics,
            )
