"""Pipeline spec, config, and the blocking ``run_pipeline`` entry point
(port of ``cosmos_curate_tpu/core/pipeline.py``).

The reference counts TPU chips (``num_tpu_chips``); the port counts CUDA
devices (``num_gpus``). The queue bound the pipelined runner sizes each
stage's input queue with is the reference's ``StreamingSpec`` formula,
``max(max_queued_lower_bound, max_queued_multiplier x workers)``, with its
two knobs on the config itself. Not ported: the execution mode and the rest
of the streaming tuning, which the reference's multi-node streaming engine
reads (ROADMAP queue A item 9b); the port's pipelined runner keeps every
stage live at once on one host, sharing its cards.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Sequence

from cosmos_curate_tpu_torch.core.stage import Stage, StageSpec
from cosmos_curate_tpu_torch.core.tasks import PipelineTask

if TYPE_CHECKING:
    from cosmos_curate_tpu_torch.core.runner import RunnerInterface


@dataclass
class PipelineConfig:
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
