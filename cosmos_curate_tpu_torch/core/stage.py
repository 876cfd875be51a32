"""Stage contracts: resources, lifecycle hooks, per-stage retries (port of
``cosmos_curate_tpu/core/stage.py``).

The accelerator is a GPU here: ``Resources.gpus`` counts CUDA devices of
the local host where the reference's ``Resources.tpus`` counts TPU chips,
``entire_gpu_host`` claims every card of the host where the reference's
``entire_tpu_host`` claims every chip, and ``NodeInfo.num_gpus`` /
``WorkerMetadata.gpu_ids`` stand for ``num_tpu_chips`` / ``tpu_chip_ids``.

``Stage.thread_safe`` and the worker counts of ``StageSpec`` are what the
pipelined runner's fan-out reads (core/pipelined_runner.py).

Not ported: ``Stage.mesh_spec`` (a stage's declared device mesh), which
waits for the port's tensor parallelism (ROADMAP queue A item 7); and the
knobs only the reference's multi-process and multi-node runners read
(``StageSpec.num_workers_per_node``, lifetimes and recycling, batch
timeouts, sampling; ``Resources.memory_gb``; ``Stage.env_name`` and
``node_affinity``), which come back with those runners (ROADMAP queue A
item 9b).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Generic, TypeVar

from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.core.tasks import PipelineTask

T = TypeVar("T", bound=PipelineTask)
V = TypeVar("V", bound=PipelineTask)


@dataclass(frozen=True)
class Resources:
    """Per-worker resource request.

    ``cpus`` may be fractional (IO-bound stages request e.g. 0.25 so many
    workers pack onto one core). ``gpus`` is in CUDA devices;
    ``entire_gpu_host`` claims every card on whichever host the worker
    lands on."""

    cpus: float = 1.0
    gpus: float = 0.0
    entire_gpu_host: bool = False

    def __post_init__(self) -> None:
        if self.cpus < 0 or self.gpus < 0:
            raise ValueError(f"negative resource request: {self}")

    @property
    def uses_gpu(self) -> bool:
        return self.gpus > 0 or self.entire_gpu_host


@dataclass(frozen=True)
class NodeInfo:
    """Identity of the host a worker is placed on."""

    node_id: str = "local"
    num_cpus: float = 1.0
    num_gpus: int = 0


@dataclass(frozen=True)
class WorkerMetadata:
    """Identity + allocation of one worker within a stage pool."""

    worker_id: str = "worker-0"
    stage_name: str = ""
    node: NodeInfo = field(default_factory=NodeInfo)
    allocation: Resources = field(default_factory=Resources)
    # CUDA device indices on the local host assigned to this worker (empty
    # for CPU stages; all local cards when entire_gpu_host)
    gpu_ids: tuple[int, ...] = ()


class Stage(Generic[T, V], abc.ABC):
    """A pipeline stage: a stateful worker template.

    Lifecycle inside each worker: ``setup_on_node`` (once per host) ->
    ``setup`` (once per worker) -> ``process_data`` repeatedly (the hot
    loop) -> ``destroy``."""

    @property
    def name(self) -> str:
        return getattr(self, "_display_name", type(self).__name__)

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

    @property
    def thread_safe(self) -> bool:
        """True when concurrent ``process_data`` calls on DISJOINT batches
        are safe: no mutable state on ``self`` shared across calls (per-task
        mutation is fine; every batch owns its tasks). The pipelined runner
        fans a stage out across worker threads only when it declares this.
        Default False: an unannotated stage runs on one worker."""
        return False

    def setup_on_node(self, node: NodeInfo, worker: WorkerMetadata) -> None:
        """Once per host before any worker setup (e.g. weight staging)."""

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


@dataclass
class StageSpec(Generic[T, V]):
    """A stage plus its scheduling knobs: worker-count bounds (the pipelined
    runner's planner reads them; ``num_workers`` fixes the pool size) and a
    retry budget (a failing batch is run up to ``num_run_attempts`` times
    before it is dropped or aborts the run)."""

    stage: Stage[T, V]
    num_workers: int | None = None  # fixed pool size; None = autoscale
    min_workers: int = 1
    max_workers: int | None = None
    num_run_attempts: int = 1

    @property
    def name(self) -> str:
        return self.stage.name
