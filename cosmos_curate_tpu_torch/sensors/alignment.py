"""Multi-sensor temporal alignment (port of
``cosmos_curate_tpu/sensors/alignment.py``).

Nearest-timestamp alignment within a tolerance, on a grid of target times
at a fixed rate over the span that every requested camera covers.
"""

from __future__ import annotations

import bisect
from typing import Sequence

from cosmos_curate_tpu_torch.sensors.data import AlignedFrame, SensorSession


def nearest(sorted_ts: Sequence[float], target: float) -> int:
    """Index of the element of ``sorted_ts`` closest to ``target``."""
    i = bisect.bisect_left(sorted_ts, target)
    if i == 0:
        return 0
    if i >= len(sorted_ts):
        return len(sorted_ts) - 1
    return i if sorted_ts[i] - target < target - sorted_ts[i - 1] else i - 1


def sampling_grid(session: SensorSession, *, rate_hz: float, cameras: list[str] | None = None):
    """Target timestamps at ``rate_hz`` over the span covered by ALL cameras."""
    cams = cameras or sorted(session.cameras)
    if not cams or any(not session.cameras.get(c) for c in cams):
        return []
    start = max(session.cameras[c][0].timestamp_s for c in cams)
    end = min(session.cameras[c][-1].timestamp_s for c in cams)
    if end < start or rate_hz <= 0:
        return []
    step = 1.0 / rate_hz
    out = []
    t = start
    while t <= end + 1e-9:
        out.append(round(t, 9))
        t += step
    return out


def align(
    session: SensorSession,
    *,
    rate_hz: float = 2.0,
    cameras: list[str] | None = None,
    tolerance_s: float = 0.1,
) -> list[AlignedFrame]:
    """Assemble aligned multi-camera (+gps/imu) frames on the sampling grid;
    grid points where any camera misses the tolerance are dropped."""
    cams = cameras or sorted(session.cameras)
    if any(not session.cameras.get(c) for c in cams):
        return []  # a requested camera has no frames (matches sampling_grid)
    cam_ts = {c: [f.timestamp_s for f in session.cameras[c]] for c in cams}
    gps_ts = [g.timestamp_s for g in session.gps]
    imu_ts = [s.timestamp_s for s in session.imu]
    frames: list[AlignedFrame] = []
    for t in sampling_grid(session, rate_hz=rate_hz, cameras=cams):
        aligned = AlignedFrame(timestamp_s=t)
        ok = True
        for c in cams:
            idx = nearest(cam_ts[c], t)
            ref = session.cameras[c][idx]
            if abs(ref.timestamp_s - t) > tolerance_s:
                ok = False
                break
            aligned.cameras[c] = ref
        if not ok:
            continue
        if gps_ts:
            g = session.gps[nearest(gps_ts, t)]
            if abs(g.timestamp_s - t) <= tolerance_s:
                aligned.gps = g
        if imu_ts:
            s = session.imu[nearest(imu_ts, t)]
            if abs(s.timestamp_s - t) <= tolerance_s:
                aligned.imu = s
        frames.append(aligned)
    return frames
