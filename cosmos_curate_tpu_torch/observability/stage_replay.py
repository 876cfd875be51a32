"""Stage save / replay: record real per-stage inputs, re-run one stage
offline (port of ``cosmos_curate_tpu/observability/stage_replay.py``).

``stage_save_wrapper`` subclasses a stage at run time (``SavingStage``) so a
sampled share of its ``process_data`` batches is pickled to
``<output>/stage_inputs/<stage>/batch-<ns>.pkl`` before the stage runs
them; ``run_stage_replay`` later runs one stage over those batches
(setup -> process each batch -> destroy), off the pipeline.

A saved batch must load on a host without a card, so the stage boundaries
must hold host data only: a task that holds a CUDA tensor is refused with
a ``ValueError`` naming its path (``cuda_tensor_paths``), never pickled
with its device storage. Host code: torch is never imported here (a CUDA
tensor can only exist once torch is loaded, so the check reads it from
``sys.modules``).
"""

from __future__ import annotations

import pickle
import random
import sys
import time
from dataclasses import dataclass, fields, is_dataclass
from pathlib import Path
from typing import Any

from cosmos_curate_tpu_torch.storage.client import write_bytes
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class StageSaveConfig:
    output_path: str
    sample_rate: float = 0.1  # share of process_data batches recorded
    stages: tuple[str, ...] = ()  # () = every stage
    seed: int = 0


# a refused batch names at most this many of its CUDA tensors
_MAX_PATHS = 8


def cuda_tensor_paths(obj: Any, path: str = "$") -> list[str]:
    """Paths of the CUDA tensors in a task tree (dataclass fields, dicts,
    sequences, object attributes), at most ``_MAX_PATHS`` of them."""
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    found: list[str] = []
    seen: set[int] = set()

    def walk(x: Any, p: str) -> None:
        if len(found) >= _MAX_PATHS or id(x) in seen:
            return
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                found.append(p)
            return
        if isinstance(x, (str, bytes, bytearray, memoryview, int, float, bool, type(None))):
            return
        if type(x).__module__ == "numpy":
            return
        seen.add(id(x))
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{p}.{k}")
        elif isinstance(x, (list, tuple, set, frozenset)):
            for i, v in enumerate(x):
                walk(v, f"{p}[{i}]")
        elif is_dataclass(x) and not isinstance(x, type):
            for f in fields(x):
                walk(getattr(x, f.name, None), f"{p}.{f.name}")
        elif hasattr(x, "__dict__") and not isinstance(x, type):
            for k, v in vars(x).items():
                walk(v, f"{p}.{k}")

    walk(obj, path)
    return found


def stage_save_wrapper(stage, config: StageSaveConfig):
    """Dynamic subclass recording sampled ``process_data`` inputs; the
    stage keeps its name. Returns the same instance."""
    if config.stages and stage.name not in config.stages:
        return stage
    cls = type(stage)
    rng = random.Random(config.seed)
    display = stage.name

    class SavingStage(cls):  # type: ignore[misc, valid-type]
        def process_data(self, tasks):
            if rng.random() < config.sample_rate:
                on_card = cuda_tensor_paths(tasks, "batch")
                if on_card:
                    raise ValueError(
                        f"stage-save of {display}: the batch holds CUDA tensors at {on_card}; "
                        "stage boundaries must hold host data (numpy), so a saved batch loads without a card"
                    )
                stamp = time.time_ns()
                path = f"{config.output_path.rstrip('/')}/stage_inputs/{display}/batch-{stamp}.pkl"
                try:
                    write_bytes(path, pickle.dumps(tasks, protocol=5))
                except Exception:
                    logger.exception("stage-save failed for %s", display)
            return cls.process_data(self, tasks)

    stage.__class__ = SavingStage
    stage._display_name = display  # type: ignore[attr-defined]
    return stage


def load_saved_batches(saved_root: str, stage_name: str) -> list[list]:
    root = Path(saved_root) / "stage_inputs" / stage_name
    return [pickle.loads(p.read_bytes()) for p in sorted(root.glob("batch-*.pkl"))]


def run_stage_replay(stage, saved_root: str) -> list[list]:
    """Run one stage directly over its recorded inputs: setup -> process
    each batch -> destroy. Returns the output batches."""
    from cosmos_curate_tpu_torch.core.stage import NodeInfo, WorkerMetadata

    batches = load_saved_batches(saved_root, stage.name)
    if not batches:
        raise FileNotFoundError(f"no saved batches for stage {stage.name} under {saved_root}")
    node = NodeInfo(node_id="replay")
    meta = WorkerMetadata(worker_id="replay-0", stage_name=stage.name, node=node)
    stage.setup_on_node(node, meta)
    stage.setup(meta)
    outputs = []
    try:
        for batch in batches:
            outputs.append(stage.process_data(batch))
    finally:
        stage.destroy()
    logger.info("replayed %d batches through %s", len(batches), stage.name)
    return outputs
