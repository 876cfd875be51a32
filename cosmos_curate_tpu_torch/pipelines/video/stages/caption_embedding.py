"""Caption-embedding stage: T5 over window captions (port of
``cosmos_curate_tpu/pipelines/video/stages/caption_embedding.py``).

Each window's caption of ``prompt_variant``, else its first non-empty
caption, goes through ``T5EncoderTPU`` in one call per stage batch; the
per-token embeddings land on ``Window.t5_embedding``.
"""

from __future__ import annotations

import torch

from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import SplitPipeTask
from cosmos_curate_tpu_torch.models.t5 import T5_BASE, T5Config, T5EncoderTPU


class CaptionEmbeddingStage(Stage[SplitPipeTask, SplitPipeTask]):
    """T5 caption embeddings on ``device`` ("cuda" unless the caller asks
    for the CPU); ``params``: a ``state_dict`` of the encoder, else the
    staged checkpoint, else the seeded init."""

    def __init__(
        self,
        *,
        cfg: T5Config = T5_BASE,
        prompt_variant: str = "default",
        params: dict | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.prompt_variant = prompt_variant
        self._model = T5EncoderTPU(cfg, params=params, device=device)

    @property
    def model(self) -> ModelInterface:
        return self._model

    @property
    def resources(self) -> Resources:
        # a stage on the CPU claims no card from the runner's budget
        return Resources(cpus=1.0, gpus=1.0 if self._model.device.type == "cuda" else 0.0)

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        windows = []
        texts = []
        for task in tasks:
            for clip in task.video.clips:
                for win in clip.windows:
                    text = win.caption.get(self.prompt_variant) or next((v for v in win.caption.values() if v), "")
                    if text:
                        windows.append(win)
                        texts.append(text)
        if texts:
            for win, sample in zip(windows, self._model.encode(texts), strict=True):
                win.t5_embedding = sample.embedding
        return tasks
