"""Stage contract: resources and lifecycle hooks (port of
``cosmos_curate_tpu/core/stage.py``, the part a stage declares).

The accelerator is a GPU here: ``Resources.gpus`` counts CUDA devices of
the local host where the reference's ``Resources.tpus`` counts TPU chips.
The scheduling knobs the reference's runners read (node setup, memory and
whole-host requests, device ids, thread safety, mesh declarations) come
with the port of those runners (ROADMAP queue A item 1).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Generic, TypeVar

from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.core.tasks import PipelineTask

T = TypeVar("T", bound=PipelineTask)
V = TypeVar("V", bound=PipelineTask)


@dataclass(frozen=True)
class Resources:
    """Per-worker resource request. ``cpus`` may be fractional; ``gpus`` is
    in CUDA devices."""

    cpus: float = 1.0
    gpus: float = 0.0

    def __post_init__(self) -> None:
        if self.cpus < 0 or self.gpus < 0:
            raise ValueError(f"negative resource request: {self}")


@dataclass(frozen=True)
class WorkerMetadata:
    """Identity of one worker within a stage pool."""

    worker_id: str = "worker-0"
    stage_name: str = ""


class Stage(Generic[T, V], abc.ABC):
    """A pipeline stage: a stateful worker template.

    Lifecycle inside each worker: ``setup`` (once) -> ``process_data``
    repeatedly (the hot loop) -> ``destroy``."""

    @property
    def resources(self) -> Resources:
        return Resources(cpus=1.0)

    @property
    def model(self) -> ModelInterface | None:
        """Model this stage drives; ``setup`` sets it up."""
        return None

    @property
    def batch_size(self) -> int:
        """How many tasks ``process_data`` receives per call."""
        return 1

    def setup(self, worker: WorkerMetadata) -> None:
        """Once per worker (load model, open handles)."""
        model = self.model
        if model is not None:
            model.setup()

    @abc.abstractmethod
    def process_data(self, tasks: list[T]) -> list[V] | None:
        """Process a batch of tasks; may emit a different number of tasks
        than received. ``None`` drops the batch."""

    def destroy(self) -> None:
        """Worker teardown (flush artifacts, free device memory)."""
