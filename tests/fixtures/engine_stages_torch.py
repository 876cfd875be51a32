"""Toy stages of the streaming-engine and map-runner tests, on the port's
stage contract: tests/fixtures/engine_stages_jax.py's stages, line for
line. Module-level, so spawned workers import them by reference."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.core.tasks import PipelineTask

GPU = {"gpus": 1.0}


@dataclass
class Item(PipelineTask):
    value: int = 0
    trail: list = field(default_factory=list)


class AddStage(Stage):
    def __init__(self, amount: int = 1):
        self.amount = amount

    @property
    def resources(self):
        return Resources(cpus=0.25)

    def process_data(self, tasks):
        return [Item(value=t.value + self.amount, trail=t.trail + ["add"]) for t in tasks]


class FanOutStage(Stage):
    @property
    def resources(self):
        return Resources(cpus=0.25)

    def process_data(self, tasks):
        out = []
        for t in tasks:
            out.append(Item(value=t.value * 10, trail=t.trail + ["fan"]))
            out.append(Item(value=t.value * 10 + 1, trail=t.trail + ["fan"]))
        return out


class DropOddStage(Stage):
    @property
    def resources(self):
        return Resources(cpus=0.25)

    def process_data(self, tasks):
        kept = [t for t in tasks if t.value % 2 == 0]
        return kept or None


class FailOn13Stage(Stage):
    """Every batch holding a 13 fails, on every attempt."""

    @property
    def resources(self):
        return Resources(cpus=0.25)

    def process_data(self, tasks):
        if any(t.value == 13 for t in tasks):
            raise RuntimeError("boom on 13")
        return tasks


class CrashStage(Stage):
    """A 7 kills its worker process outright (no exception)."""

    @property
    def resources(self):
        return Resources(cpus=0.25)

    def process_data(self, tasks):
        if any(t.value == 7 for t in tasks):
            os._exit(42)
        return tasks


class BadSetupStage(AddStage):
    def setup(self, worker):
        raise ValueError("no weights")


class PidStage(Stage):
    """Appends the process id it ran in and its ``CUDA_VISIBLE_DEVICES``;
    ``device=True`` claims the accelerator, so the runners keep it in the
    driver."""

    def __init__(self, device: bool = False):
        self.device = device

    @property
    def resources(self):
        return Resources(cpus=0.5, **(GPU if self.device else {}))

    def process_data(self, tasks):
        env = os.environ.get("CUDA_VISIBLE_DEVICES")
        return [Item(value=t.value, trail=t.trail + [os.getpid(), env]) for t in tasks]


class Num(PipelineTask):
    def __init__(self, v: int) -> None:
        self.v = v
        self.pids: list[int] = []


class Add(Stage):
    """The map-runner tests' stage: batches of 2, fails on ``fail_values``."""

    def __init__(self, delta: int = 1, fail_values: tuple[int, ...] = ()) -> None:
        self.delta = delta
        self.fail_values = fail_values

    @property
    def name(self) -> str:
        return f"add{self.delta}"

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.5)

    @property
    def batch_size(self) -> int:
        return 2

    def process_data(self, tasks):
        for t in tasks:
            if t.v in self.fail_values:
                raise RuntimeError(f"injected failure on {t.v}")
            t.v += self.delta
            t.pids.append(os.getpid())
        return tasks


class Expand(Stage):
    """One task in, two out."""

    @property
    def name(self) -> str:
        return "expand"

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.5)

    def process_data(self, tasks):
        return [Num(t.v) for t in tasks for _ in range(2)]


class DeviceStage(Stage):
    @property
    def name(self) -> str:
        return "device"

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.5, **GPU)

    def process_data(self, tasks):
        for t in tasks:
            t.pids.append(os.getpid())
        return tasks


class NodeStampStage(Stage):
    """Adds one and stamps the node its worker was placed on. The sleep
    keeps a batch longer than a remote worker's start, so a placement
    check is about the plane, not a start-up race."""

    def __init__(self, sleep_s: float = 0.1):
        self.sleep_s = sleep_s

    @property
    def resources(self):
        return Resources(cpus=1.0)

    def setup(self, worker):
        self._node = worker.node.node_id

    def process_data(self, tasks):
        import time

        time.sleep(self.sleep_s)
        return [Item(value=t.value + 1, trail=t.trail + [self._node]) for t in tasks]
