"""Hello-world pipeline: the smallest end-to-end example (port of
``cosmos_curate_tpu/pipelines/examples/hello_world.py``).

A CPU stage uppercases text, then :class:`ScoreStage` (the counterpart of
the reference's ``JaxScoreStage``) scores each task with one torch op on
``device`` ("cuda" unless the caller asks for the CPU): host bytes ->
device tensor -> ``tanh(bytes / 128).mean(-1)`` -> host scalar.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
from cosmos_curate_tpu_torch.core.runner import RunnerInterface, SequentialRunner
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.core.tasks import PipelineTask


@dataclass
class HelloTask(PipelineTask):
    text: str = ""
    score: float | None = None
    device: str = ""


class UppercaseStage(Stage[HelloTask, HelloTask]):
    @property
    def resources(self) -> Resources:
        return Resources(cpus=0.5)

    def process_data(self, tasks: list[HelloTask]) -> list[HelloTask]:
        for t in tasks:
            t.text = t.text.upper()
        return tasks


class ScoreStage(Stage[HelloTask, HelloTask]):
    """Scores text with one device computation (the reference's
    ``JaxScoreStage``): the first 64 bytes of each text, zero-padded, as
    ``tanh(bytes / 128).mean(-1)`` in fp32 on ``device``."""

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = model_device(device, "the hello-world score stage")

    @property
    def resources(self) -> Resources:
        return Resources(cpus=1.0, gpus=1.0 if self.device.type == "cuda" else 0.0)

    @property
    def batch_size(self) -> int:
        return 8

    def process_data(self, tasks: list[HelloTask]) -> list[HelloTask]:
        batch = np.zeros((len(tasks), 64), np.uint8)
        for i, t in enumerate(tasks):
            raw = t.text.encode()[:64]
            batch[i, : len(raw)] = np.frombuffer(raw, np.uint8)
        tokens = torch.from_numpy(batch).to(self.device)
        scores = torch.tanh(tokens.float() / 128.0).mean(dim=-1).cpu().numpy()
        for t, s in zip(tasks, scores):
            t.score = float(s)
            t.device = self.device.type
        return tasks


def run_hello_world(
    texts: list[str] | None = None, runner: RunnerInterface | None = None, device: str | torch.device = "cuda"
) -> list[HelloTask]:
    texts = texts or [f"hello world {i}" for i in range(10)]
    tasks = [HelloTask(text=t) for t in texts]
    out = run_pipeline(tasks, [UppercaseStage(), ScoreStage(device)], runner=runner or SequentialRunner())
    return out or []
