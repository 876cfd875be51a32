"""Sensor group: lockstep sampling across named sensors (port of
``cosmos_curate_tpu/sensors/group.py``).

All sensors' generators advance in lockstep, one step per grid window; each
window's ``GroupFrame`` maps only the sensors with data in that window. A
sensor without coverage there is absent, and a window nobody covers yields
an empty mapping (the caller decides whether that is an error).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Generator, Protocol, runtime_checkable

import numpy as np

from cosmos_curate_tpu_torch.sensors.sampling import SamplingSpec


@runtime_checkable
class Sensor(Protocol):
    """Anything samplable on a nanosecond grid (CameraSensor, ImageSensor,
    SignalSensor, MCAP variants)."""

    @property
    def start_ns(self) -> int: ...

    @property
    def end_ns(self) -> int: ...

    def sample(self, spec: SamplingSpec) -> Generator: ...


@dataclass
class GroupFrame:
    """One grid window's aligned snapshot across the group."""

    align_timestamps_ns: np.ndarray
    sensor_data: dict[str, object] = field(default_factory=dict)


class SensorGroup:
    def __init__(self, sensors: dict[str, Sensor]) -> None:
        if not sensors:
            raise ValueError("sensors must be non-empty")
        self._sensors = dict(sensors)

    @property
    def sensors(self) -> dict[str, Sensor]:
        return dict(self._sensors)

    @property
    def start_ns(self) -> int:
        return min(s.start_ns for s in self._sensors.values())

    @property
    def end_ns(self) -> int:
        return max(s.end_ns for s in self._sensors.values())

    def sample(self, spec: SamplingSpec) -> Generator[GroupFrame, None, None]:
        """One GroupFrame per window in ``spec.grid``; every sensor receives
        the same spec (including its policy — tolerance violations propagate
        unchanged from whichever sensor raises)."""
        generators = {name: s.sample(spec) for name, s in self._sensors.items()}
        for window in spec.grid:
            data: dict[str, object] = {}
            for name, gen in generators.items():
                batch = next(gen)
                if len(batch) > 0:
                    data[name] = batch
            yield GroupFrame(align_timestamps_ns=window.timestamps_ns, sensor_data=data)
