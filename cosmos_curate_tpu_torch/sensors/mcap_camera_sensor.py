"""MCAP-backed camera sensor and video-to-MCAP capture (port of
``cosmos_curate_tpu/sensors/mcap_camera_sensor.py``).

The capture contract: raw ``rgb8`` frames on one topic with ``width`` /
``height`` channel metadata, nanosecond ``log_time`` timestamps, and a
``cosmos_curate.video_metadata.v1`` metadata record describing the source
video. Built on the SDK-free reader and writer of ``sensors/mcap.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from cosmos_curate_tpu_torch.sensors.camera_sensor import CameraData
from cosmos_curate_tpu_torch.sensors.mcap import (
    VIDEO_METADATA_RECORD_NAME,
    McapError,
    McapReader,
    McapWriter,
    channel_for_topic,
    get_metadata_record,
    load_timeline,
    make_reader,
)
from cosmos_curate_tpu_torch.sensors.sampling import NS, SamplingSpec, sample_window_indices

DEFAULT_TOPIC = "/camera/rgb"


def _rgb8_dims(channel) -> tuple[int, int]:
    if channel.message_encoding != "rgb8":
        raise McapError(
            f"expected rgb8 channel, got message_encoding={channel.message_encoding!r}"
        )
    try:
        width = int(channel.metadata["width"])
        height = int(channel.metadata["height"])
    except (KeyError, ValueError) as e:
        raise McapError(
            f"channel metadata must carry integer width/height: {channel.metadata!r}"
        ) from e
    if width <= 0 or height <= 0:
        raise McapError(f"invalid rgb8 dimensions {width}x{height}")
    return width, height


class McapCameraSensor:
    """One camera topic of an MCAP capture, sampled on nanosecond grids.

    Same ``sample(spec) -> CameraData per window`` surface as CameraSensor;
    timestamps come from message ``log_time`` (ns), frames from raw rgb8
    payloads.
    """

    def __init__(self, path: str | Path, topic: str = DEFAULT_TOPIC) -> None:
        self.path = Path(path)
        self.topic = topic
        # seekable file handle, NOT read_bytes: a 10 GB capture must not be
        # resident for the sensor's lifetime
        self._reader = make_reader(open(self.path, "rb"))
        channel = channel_for_topic(self._reader.get_summary(), topic)
        if channel is None:
            raise McapError(f"MCAP file {path} has no channel for topic {topic!r}")
        self._channel = channel
        self.width, self.height = _rgb8_dims(channel)
        self._ts_ns = load_timeline(self._reader, topic)

    def close(self) -> None:
        self._reader._f.close()

    def __enter__(self) -> "McapCameraSensor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def video_metadata(self) -> dict[str, str]:
        return get_metadata_record(self._reader, VIDEO_METADATA_RECORD_NAME)

    @property
    def timestamps_ns(self) -> np.ndarray:
        return self._ts_ns

    @property
    def start_ns(self) -> int:
        return int(self._ts_ns[0])

    @property
    def end_ns(self) -> int:
        return int(self._ts_ns[-1])

    def _frames_for_window(self, start_ns: int, end_ns_exclusive: int) -> tuple[np.ndarray, list[bytes]]:
        times, payloads = [], []
        for _, _, msg in self._reader.iter_messages(
            topics=self.topic, start_time=start_ns, end_time=end_ns_exclusive
        ):
            times.append(msg.log_time)
            payloads.append(msg.data)
        return np.asarray(times, np.int64), payloads

    def sample(self, spec: SamplingSpec):
        """One CameraData per sampling window (empty windows yield empty
        batches), decoding each selected payload once and repeating per
        grid-match count."""
        shape = (self.height, self.width, 3)
        for window in spec.grid:
            if len(window) == 0:
                sel = np.zeros(0, np.int64)
            else:
                idx, counts = sample_window_indices(
                    self._ts_ns, window, policy=spec.policy
                )
                sel = idx
            if len(sel) == 0:
                yield CameraData(
                    align_timestamps_ns=window.timestamps_ns,
                    sensor_timestamps_ns=np.zeros(0, np.int64),
                    frame_indices=np.zeros(0, np.int64),
                    frames=np.zeros((0, 0, 0, 3), np.uint8),
                    camera=self.topic,
                )
                continue
            lo = int(self._ts_ns[sel[0]])
            hi = int(self._ts_ns[sel[-1]]) + 1
            times, payloads = self._frames_for_window(lo, hi)
            # map timeline positions, not log_times: messages sharing one
            # timestamp must keep their distinct payloads (fetch order and
            # the timeline are both stable log_time sorts of file order)
            first_pos = int(np.searchsorted(self._ts_ns, lo, side="left"))
            if len(payloads) != int(np.searchsorted(self._ts_ns, hi, side="left")) - first_pos:
                raise McapError(
                    f"window fetch returned {len(payloads)} frames, timeline expects "
                    f"{int(np.searchsorted(self._ts_ns, hi, side='left')) - first_pos}"
                )
            frames = np.stack(
                [
                    np.frombuffer(payloads[i - first_pos], np.uint8).reshape(shape)
                    for i in sel
                ]
            )
            rep = np.repeat(np.arange(len(sel)), counts)
            yield CameraData(
                align_timestamps_ns=window.timestamps_ns,
                sensor_timestamps_ns=np.repeat(self._ts_ns[sel], counts),
                frame_indices=np.repeat(sel, counts),
                frames=frames[rep],
                camera=self.topic,
            )


def make_mcap_from_video(
    video_path: str | Path,
    mcap_path: str | Path,
    *,
    topic: str = DEFAULT_TOPIC,
    start_ns: int = 0,
    compression: str = "zstd",
    resize_hw: tuple[int, int] | None = None,
) -> int:
    """Convert a video file into the rgb8 MCAP capture contract; returns the
    frame count."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise ValueError(f"cannot open video {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    n = 0
    with open(mcap_path, "wb") as f, McapWriter(f, compression=compression) as w:
        cid = None
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if resize_hw is not None:
                frame = cv2.resize(frame, (resize_hw[1], resize_hw[0]))
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if cid is None:
                h, width = rgb.shape[:2]
                cid = w.register_channel(
                    topic, "rgb8", metadata={"width": str(width), "height": str(h)}
                )
            log_time = start_ns + round(n / fps * NS)
            w.add_message(cid, log_time, rgb.tobytes())
            n += 1
        cap.release()
        if cid is None:
            raise ValueError(f"video {video_path} has no frames")
        w.add_metadata(
            VIDEO_METADATA_RECORD_NAME,
            {
                "source": str(video_path),
                "fps": f"{fps:.6f}",
                "num_frames": str(n),
                "width": str(rgb.shape[1]),
                "height": str(rgb.shape[0]),
            },
        )
    return n
