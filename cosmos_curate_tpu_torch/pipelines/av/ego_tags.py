"""Ego-motion tag taxonomy and its derivation from estimated trajectories
(port of ``cosmos_curate_tpu/pipelines/av/ego_tags.py``; host code, numpy).

The tiers of the ``clip_tag`` table (``EgoSpeedTier``,
``EgoAccelerationType``, ``EgoManeuverType``) derived from the
phase-correlation trajectory (pipelines/av/trajectory.py), per-frame
image-space egomotion, for want of CAN-bus or GPS feeds. Tag values are
the enums' ``value`` strings; columns with no estimator (country,
road_type, ...) stay 'unknown'.
"""

from __future__ import annotations

from enum import Enum

import numpy as np


class EgoSpeedTier(str, Enum):
    """Speed tier."""

    high = "high"
    medium = "medium"
    low = "low"
    stand_still = "stand_still"
    unknown = "unknown"


class EgoAccelerationType(str, Enum):
    """Acceleration behavior."""

    fast_accel = "fast_accel"
    slow_accel = "slow_accel"
    fast_decel = "fast_decel"
    slow_decel = "slow_decel"
    maintain = "maintain"
    brake = "brake"
    unknown = "unknown"


class EgoManeuverType(str, Enum):
    """Maneuver class."""

    reverse = "reverse"
    change_lane_left = "lane_change_left"
    change_lane_right = "lane_change_right"
    left_turn = "left_turn"
    right_turn = "right_turn"
    curve_left = "curve_left"
    curve_right = "curve_right"
    straight = "straight"
    non_straight = "non_straight"
    unknown = "unknown"


# image-space speed thresholds in pixels/second at the trajectory
# estimator's working resolution (128x128 @ 4 fps, trajectory.py:133);
# calibrated so a full-frame pan in ~2 s reads as 'high'
_SPEED_STAND_STILL = 2.0
_SPEED_LOW = 12.0
_SPEED_MEDIUM = 40.0

# relative speed change over the clip that counts as accel/decel
_ACCEL_SLOW = 0.25
_ACCEL_FAST = 0.75
# mean |heading change| per step (radians) separating straight / curve / turn
_CURVE_RAD = 0.15
_TURN_RAD = 0.45


def derive_ego_tags(positions: np.ndarray, fps: float) -> dict[str, str]:
    """Trajectory positions [T, 2] (pixels, cumulative) at ``fps`` ->
    {ego_speed, ego_acceleration, ego_curve, ego_turn} tag values."""
    pos = np.asarray(positions, np.float32)
    if pos.shape[0] < 3:
        return {
            "ego_speed": EgoSpeedTier.unknown.value,
            "ego_acceleration": EgoAccelerationType.unknown.value,
            "ego_curve": EgoManeuverType.unknown.value,
            "ego_turn": EgoManeuverType.unknown.value,
        }
    steps = np.diff(pos, axis=0)  # [T-1, 2]
    speeds = np.hypot(steps[:, 0], steps[:, 1]) * fps  # px/s per step
    mean_speed = float(speeds.mean())

    if mean_speed < _SPEED_STAND_STILL:
        speed = EgoSpeedTier.stand_still
    elif mean_speed < _SPEED_LOW:
        speed = EgoSpeedTier.low
    elif mean_speed < _SPEED_MEDIUM:
        speed = EgoSpeedTier.medium
    else:
        speed = EgoSpeedTier.high

    # acceleration: compare mean speed over the clip's back half vs front
    # half — robust to single-step phase-correlation outliers
    half = len(speeds) // 2
    front = float(speeds[:half].mean()) if half else mean_speed
    back = float(speeds[half:].mean())
    base = max(front, _SPEED_STAND_STILL)
    rel = (back - front) / base
    if speed is EgoSpeedTier.stand_still:
        accel = EgoAccelerationType.maintain
    elif rel > _ACCEL_FAST:
        accel = EgoAccelerationType.fast_accel
    elif rel > _ACCEL_SLOW:
        accel = EgoAccelerationType.slow_accel
    elif rel < -_ACCEL_FAST:
        accel = EgoAccelerationType.brake if back < _SPEED_STAND_STILL else EgoAccelerationType.fast_decel
    elif rel < -_ACCEL_SLOW:
        accel = EgoAccelerationType.slow_decel
    else:
        accel = EgoAccelerationType.maintain

    # heading analysis over steps with real motion (tiny steps have
    # meaningless angles)
    moving = steps[np.hypot(steps[:, 0], steps[:, 1]) * fps > _SPEED_STAND_STILL]
    if moving.shape[0] < 2 or speed is EgoSpeedTier.stand_still:
        return {
            "ego_speed": speed.value,
            "ego_acceleration": accel.value,
            "ego_curve": EgoManeuverType.straight.value,
            "ego_turn": EgoManeuverType.straight.value,
        }
    angles = np.arctan2(moving[:, 1], moving[:, 0])
    # wrap heading deltas into (-pi, pi]
    dyaw = np.angle(np.exp(1j * np.diff(angles)))
    mean_abs = float(np.abs(dyaw).mean())
    net = float(dyaw.sum())  # signed total heading change; y is image-down
    if mean_abs < _CURVE_RAD:
        curve = turn = EgoManeuverType.straight
    elif mean_abs < _TURN_RAD:
        curve = EgoManeuverType.curve_right if net > 0 else EgoManeuverType.curve_left
        turn = EgoManeuverType.straight
    else:
        curve = EgoManeuverType.non_straight
        turn = EgoManeuverType.right_turn if net > 0 else EgoManeuverType.left_turn
    return {
        "ego_speed": speed.value,
        "ego_acceleration": accel.value,
        "ego_curve": curve.value,
        "ego_turn": turn.value,
    }
