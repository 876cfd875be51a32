"""Dynamic task-chunking demo pipeline (port of
``cosmos_curate_tpu/pipelines/examples/chunking_demo.py``; host work only).

It shows a stage emitting a different number of tasks than it received — the
mechanism that bounds memory on multi-hour videos (one video task → N
clip-chunk tasks) — and a downstream stage consuming the chunks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
from cosmos_curate_tpu_torch.core.runner import RunnerInterface, SequentialRunner
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.core.tasks import PipelineTask


@dataclass
class WorkItem(PipelineTask):
    name: str = ""
    payload: list = field(default_factory=list)
    chunk_index: int = 0
    num_chunks: int = 1

    @property
    def fraction(self) -> float:
        return 1.0 / max(1, self.num_chunks)


class ProduceStage(Stage):
    """Emits one big task per input (simulating a long video's clip list)."""

    def __init__(self, items_per_task: int = 100):
        self.items_per_task = items_per_task

    def process_data(self, tasks):
        return [
            WorkItem(name=t.name, payload=list(range(self.items_per_task)))
            for t in tasks
        ]


class ChunkStage(Stage):
    """Dynamic chunking: one task in → ceil(len/chunk) tasks out."""

    def __init__(self, chunk_size: int = 16):
        self.chunk_size = chunk_size

    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.25)

    def process_data(self, tasks):
        out = []
        for t in tasks:
            chunks = [
                t.payload[i : i + self.chunk_size]
                for i in range(0, len(t.payload), self.chunk_size)
            ]
            for i, chunk in enumerate(chunks):
                out.append(
                    WorkItem(name=t.name, payload=chunk, chunk_index=i, num_chunks=len(chunks))
                )
        return out


class SumStage(Stage):
    def process_data(self, tasks):
        for t in tasks:
            t.payload = [sum(t.payload)]
        return tasks


def run_chunking_demo(
    num_inputs: int = 3, runner: RunnerInterface | None = None
) -> list[WorkItem]:
    tasks = [WorkItem(name=f"video_{i}") for i in range(num_inputs)]
    out = run_pipeline(
        tasks,
        [ProduceStage(), ChunkStage(), SumStage()],
        runner=runner or SequentialRunner(),
    )
    return out or []
