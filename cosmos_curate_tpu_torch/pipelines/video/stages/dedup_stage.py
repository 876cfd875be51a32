"""Incremental dedup stage: query the persistent corpus index as clips flow
(port of ``cosmos_curate_tpu/pipelines/video/stages/dedup_stage.py``).

Each task's freshly embedded clips are queried against the corpus index
(dedup/corpus_index.py, scored on ``device``: "cuda" unless the caller asks
for the CPU); clips within ``eps`` cosine distance of an indexed neighbour
are flagged (score-only) or dropped (enable) before the writer persists
them.

Provenance gate: when the index's embedding weights are a seeded init
(``models.registry.weights_provenance`` is "random"), similarity is noise,
so the stage flags nothing (and warns once) unless
``CURATE_INDEX_ALLOW_RANDOM`` opts in.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import SplitPipeTask
from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex, incremental_dedup
from cosmos_curate_tpu_torch.dedup.index_store import allow_random_provenance
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class IncrementalDedupStage(Stage[SplitPipeTask, SplitPipeTask]):
    """Flags or drops clips that duplicate an indexed corpus neighbour.

    ``index_path`` names a corpus index; when none exists yet (the first run
    into a fresh output root) the stage passes everything through, and the
    end-of-run consolidation builds the index the next run queries."""

    def __init__(self, index_path: str, *, eps: float = 0.07, nprobe: int = 0, score_only: bool = False,
                 device: str | torch.device = "cuda") -> None:
        self.index_path = index_path.rstrip("/")
        self.eps = eps
        self.nprobe = nprobe  # 0 = the index's default
        self.score_only = score_only
        self.device = model_device(device, "IncrementalDedupStage")
        self._index: CorpusIndex | None = None
        self._gate_logged = False

    @property
    def resources(self) -> Resources:
        # the reference's claim: the scoring products are small beside the
        # embedding stage's, so the stage holds no card of its own
        return Resources(cpus=1.0)

    def setup(self, worker) -> None:
        if not CorpusIndex.exists(self.index_path):
            logger.warning("no corpus index at %s yet: incremental dedup passes everything through this run "
                           "(the end-of-run consolidation builds it)", self.index_path)
            return
        self._index = CorpusIndex.open(self.index_path, device=self.device)

    def _provenance_ok(self, model: str) -> bool:
        if registry.weights_provenance(model) != "random" or allow_random_provenance():
            return True
        if not self._gate_logged:
            self._gate_logged = True
            logger.warning("incremental dedup disabled: %s weights are random init, so similarity to the index "
                           "would be noise (stage a checkpoint or set CURATE_INDEX_ALLOW_RANDOM=1)", model)
        return False

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        if self._index is None:
            return tasks
        model = self._index.meta.get("model", "")
        for task in tasks:
            video = task.video
            clips = [c for c in video.clips if model in c.embeddings]
            if not clips or not self._provenance_ok(model):
                continue
            ids = [str(c.uuid) for c in clips]
            vecs = np.stack([c.embeddings[model] for c in clips])
            result = incremental_dedup(self._index, ids, vecs, eps=self.eps, nprobe=self.nprobe or None)
            by_id = {str(c.uuid): c for c in clips}
            for cid in result["removed"]:
                clip = by_id[cid]
                clip.duplicate_of = result["duplicate_of"].get(cid, "")
                if not self.score_only:
                    clip.filtered_by = "dedup"
            if not self.score_only and result["removed"]:
                removed = set(result["removed"])
                video.filtered_clips.extend(c for c in video.clips if str(c.uuid) in removed)
                video.clips = [c for c in video.clips if str(c.uuid) not in removed]
            task.stage_perf["dedup_duplicates"] = task.stage_perf.get("dedup_duplicates", 0) + len(result["removed"])
        return tasks
