"""VLM semantic filter stage (port of
``cosmos_curate_tpu/pipelines/video/stages/semantic_filter.py``).

One yes/no question per clip (``SEMANTIC_FILTER_PROMPTS``), asked of the
caption engine over ``num_frames`` of the clip's frames; the answer is
parsed by ``parse_yes_no``. A "no" filters the clip
(``filtered_by="semantic"``), an unparseable answer keeps it unless
``keep_on_unparseable`` is False, and ``score_only`` keeps every clip with
its verdict in ``clip.semantic_pass``.

The stage is one owner of the process-wide ``SharedCaptionEngine``
(resolved as the caption stage resolves its model), so it shares the engine
and its weights with the caption and enhance stages; its device work runs in
the engine's continuous-batching loop. It runs on ``device="cuda"`` unless
the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature, SplitPipeTask
from cosmos_curate_tpu_torch.models.prompts import SEMANTIC_FILTER_PROMPTS
from cosmos_curate_tpu_torch.models.vlm.engine import CaptionRequest, SamplingConfig
from cosmos_curate_tpu_torch.models.vlm.model import VLMConfig
from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import _owner_tag, resolve_caption_model


def parse_yes_no(text: str) -> bool | None:
    t = text.strip().lower()
    if t.startswith("yes"):
        return True
    if t.startswith("no"):
        return False
    return None


class SemanticFilterStage(Stage[SplitPipeTask, SplitPipeTask]):
    """Drops the clips the VLM answers "no" for (or scores only)."""

    def __init__(
        self,
        *,
        prompt_variant: str = "default",
        cfg: VLMConfig | None = None,
        max_batch: int = 8,
        model_flavor: str | None = None,
        score_only: bool = False,
        keep_on_unparseable: bool = True,
        num_frames: int = 4,
        extraction: FrameExtractionSignature = FrameExtractionSignature("fps", 2.0),
        device: str | torch.device = "cuda",
    ) -> None:
        self.prompt = SEMANTIC_FILTER_PROMPTS[prompt_variant]
        self.score_only = score_only
        self.keep_on_unparseable = keep_on_unparseable
        self.num_frames = num_frames
        self.extraction = extraction
        self.owner = _owner_tag("semantic-filter")
        self._model = resolve_caption_model(cfg, model_flavor, max_batch, device)

    @property
    def model(self) -> ModelInterface:
        return self._model

    @property
    def resources(self) -> Resources:
        return Resources(cpus=1.0, entire_gpu_host=self._model.device.type == "cuda")

    @property
    def batch_size(self) -> int:
        # deep batches keep the engine's continuous batch full across clips;
        # the shared question prefix then hits the engine's prefix KV cache
        # on every request after the first
        return 16

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        engine = self._model.engine
        if engine is None:
            raise RuntimeError("SemanticFilterStage.process_data before setup()")
        key = self.extraction.key()
        targets = {}
        for task in tasks:
            for clip in task.video.clips:
                frames = clip.extracted_frames.get(key)
                if frames is None or frames.shape[0] == 0:
                    continue
                idx = np.linspace(0, frames.shape[0] - 1, self.num_frames).round().astype(int)
                targets[str(clip.uuid)] = clip
                pre, ids = self._model.encode_prompt(self.prompt, has_vision=True)
                engine.add_request(CaptionRequest(
                    request_id=str(clip.uuid),
                    prefix_ids=pre,
                    prompt_ids=ids,
                    frames=frames[idx],
                    frame_fps=self.num_frames / max(clip.duration_s, 1e-6),
                    sampling=SamplingConfig(max_new_tokens=8),
                    owner=self.owner,
                ))
        if not targets:
            return tasks
        verdicts = {r.request_id: parse_yes_no(r.text) for r in engine.run_until_complete(owner=self.owner)}
        for task in tasks:
            kept = []
            for clip in task.video.clips:
                if str(clip.uuid) not in targets:
                    kept.append(clip)  # never asked (no frames): keep
                    continue
                verdict = verdicts.get(str(clip.uuid))
                clip.semantic_pass = verdict
                keep = verdict if verdict is not None else self.keep_on_unparseable
                if self.score_only or keep:
                    kept.append(clip)
                else:
                    clip.filtered_by = "semantic"
                    task.video.filtered_clips.append(clip)
            task.video.clips = kept
        return tasks
