"""Caption enhancement stage: an LM rewrite of existing captions (port of
``cosmos_curate_tpu/pipelines/video/stages/enhance_caption.py``).

Every window caption of ``prompt_variant`` is sent back to the caption
engine as a text-only request (``ENHANCE_PROMPT`` + the caption, no vision
prefill), and the answer lands in ``window.enhanced_caption[variant]``. The
stage is one owner of the process-wide ``SharedCaptionEngine``, so one
model serves both passes. It runs on ``device="cuda"`` unless the caller
asks for the CPU.
"""

from __future__ import annotations

import torch

from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import SplitPipeTask
from cosmos_curate_tpu_torch.models.prompts import ENHANCE_PROMPT
from cosmos_curate_tpu_torch.models.vlm.engine import CaptionRequest, SamplingConfig
from cosmos_curate_tpu_torch.models.vlm.model import VLMConfig
from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import _owner_tag, resolve_caption_model


class EnhanceCaptionStage(Stage[SplitPipeTask, SplitPipeTask]):
    def __init__(
        self,
        *,
        prompt_variant: str = "default",
        cfg: VLMConfig | None = None,
        max_batch: int = 8,
        max_new_tokens: int = 128,
        model_flavor: str | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.prompt_variant = prompt_variant
        self.max_new_tokens = max_new_tokens
        self.owner = _owner_tag("enhance-caption")
        self._model = resolve_caption_model(cfg, model_flavor, max_batch, device)
        # a small-context flavor clamps generation instead of refusing
        # requests
        if self.max_new_tokens >= self._model.cfg.max_seq // 2:
            self.max_new_tokens = self._model.cfg.max_seq // 2

    @property
    def model(self) -> ModelInterface:
        return self._model

    @property
    def resources(self) -> Resources:
        return Resources(cpus=1.0, entire_gpu_host=self._model.device.type == "cuda")

    @property
    def batch_size(self) -> int:
        # deep batches keep the engine's continuous batch full across clips
        # (one task per call would decode every rewrite alone)
        return 16

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        engine = self._model.engine
        if engine is None:
            raise RuntimeError("EnhanceCaptionStage.process_data before setup()")
        windows = {}
        for task in tasks:
            for clip in task.video.clips:
                for i, win in enumerate(clip.windows):
                    text = win.caption.get(self.prompt_variant, "")
                    if not text:
                        continue
                    rid = f"{clip.uuid}-{i}"
                    windows[rid] = win
                    pre, ids = self._model.encode_prompt(ENHANCE_PROMPT + text, has_vision=False)
                    engine.add_request(CaptionRequest(
                        request_id=rid,
                        prefix_ids=pre,
                        prompt_ids=ids,
                        sampling=SamplingConfig(max_new_tokens=self.max_new_tokens),
                        owner=self.owner,
                    ))
        if windows:
            for res in engine.run_until_complete(owner=self.owner):
                win = windows.get(res.request_id)
                if win is not None:
                    win.enhanced_caption[self.prompt_variant] = res.text
        return tasks
