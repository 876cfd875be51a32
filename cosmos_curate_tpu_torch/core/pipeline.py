"""Pipeline spec, config, and the blocking ``run_pipeline`` entry point
(port of ``cosmos_curate_tpu/core/pipeline.py``).

The reference counts TPU chips (``num_tpu_chips``); the port counts CUDA
devices (``num_gpus``). The queue bound the pipelined runner sizes each
stage's input queue with is the reference's ``StreamingSpec`` formula,
``max(max_queued_lower_bound, max_queued_multiplier x workers)``, with its
two knobs on the config itself, where both the pipelined runner and the
streaming engine read them. ``execution_mode`` (STREAMING keeps every stage
live at once; BATCH runs stage by stage) and the rest of ``StreamingSpec``
(the autoscaler's cadence and speed window, the object store's share of
host memory) are what the streaming engine reads (engine/runner.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Sequence

from cosmos_curate_tpu_torch.core.stage import Stage, StageSpec
from cosmos_curate_tpu_torch.core.tasks import PipelineTask

if TYPE_CHECKING:
    from cosmos_curate_tpu_torch.core.runner import RunnerInterface


class ExecutionMode(enum.Enum):
    """STREAMING keeps every stage's pool live at once; BATCH runs stage by
    stage, each stage with the whole budget."""

    STREAMING = "streaming"
    BATCH = "batch"


@dataclass
class StreamingSpec:
    """The streaming engine's tuning; the reference's defaults (a 180 s
    autoscale cadence)."""

    autoscale_interval_s: float = 180.0
    speed_estimation_window_s: float = 180.0
    # the object store's budget for payloads in flight, a share of host RAM
    object_store_fraction: float = 0.3


@dataclass
class PipelineConfig:
    execution_mode: ExecutionMode = ExecutionMode.STREAMING
    streaming: StreamingSpec = field(default_factory=StreamingSpec)
    return_last_stage_outputs: bool = True
    # CPUs the runner's planner may hand out; None = the host's core count
    num_cpus: float | None = None
    # CUDA devices of the host; None = discover them (torch.cuda) when a
    # stage claims one
    num_gpus: int | None = None
    # a stage's input queue holds max(lower bound, multiplier x workers)
    max_queued_multiplier: float = 1.5
    max_queued_lower_bound: int = 16


@dataclass
class PipelineSpec:
    input_data: list[PipelineTask]
    stages: list[StageSpec]
    config: PipelineConfig = field(default_factory=PipelineConfig)


def _normalize_stages(stages: Sequence[Stage | StageSpec]) -> list[StageSpec]:
    return [s if isinstance(s, StageSpec) else StageSpec(stage=s) for s in stages]


def run_pipeline(
    input_tasks: Sequence[PipelineTask],
    stages: Sequence[Stage | StageSpec],
    config: PipelineConfig | None = None,
    runner: RunnerInterface | None = None,
    *,
    skip_validation: bool = False,
) -> list[PipelineTask] | None:
    """Run ``input_tasks`` through ``stages``; blocks until done.

    ``runner`` defaults to ``default_runner()`` (``CURATE_RUNNER`` picks
    one; on one host it is the ``PipelinedRunner``); tests inject a
    ``SequentialRunner`` to run every stage in-process, stage by stage.

    The spec is validated before any worker starts (stage-to-stage task
    types, duplicate names, device claims against the declared host; see
    analysis/graph_lint.py): a mis-wired pipeline raises
    ``PipelineValidationError`` at once. ``skip_validation=True`` bypasses
    the pre-flight.
    """
    from cosmos_curate_tpu_torch.core.runner import default_runner

    config = config or PipelineConfig()
    spec = PipelineSpec(input_data=list(input_tasks), stages=_normalize_stages(stages), config=config)
    if not skip_validation:
        from cosmos_curate_tpu_torch.analysis.graph_lint import validate_pipeline_spec

        validate_pipeline_spec(spec)
    active = runner if runner is not None else default_runner()
    return active.run(spec)
