"""Image semantic filter and classifier stages (port of
``cosmos_curate_tpu/pipelines/image/filters.py``).

``ImageSemanticFilterStage`` asks the caption engine a yes/no question per
image (``SEMANTIC_FILTER_PROMPTS["image-default"]``, 8 new tokens) and
filters the images answered "no"; ``ImageClassifierStage`` asks for one
label of a set (12 new tokens) and parses it with ``parse_label``. Both
are owners of the process-wide ``SharedCaptionEngine``
(:class:`~cosmos_curate_tpu_torch.pipelines.image.annotate.CaptionFamilyStage`),
on ``device`` ("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

import torch

from cosmos_curate_tpu_torch.models.prompts import SEMANTIC_FILTER_PROMPTS
from cosmos_curate_tpu_torch.models.vlm.model import VLM_BASE, VLMConfig
from cosmos_curate_tpu_torch.pipelines.image.annotate import CaptionFamilyStage, ImageTask
from cosmos_curate_tpu_torch.pipelines.video.stages.semantic_filter import parse_yes_no


class ImageSemanticFilterStage(CaptionFamilyStage):
    """Marks images the VLM answers "no" for as filtered (or scores only)."""

    max_new_tokens = 8

    def __init__(
        self,
        *,
        prompt_variant: str = "image-default",
        user_prompt: str | None = None,
        cfg: VLMConfig = VLM_BASE,
        max_batch: int = 8,
        score_only: bool = False,
        keep_on_unparseable: bool = True,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__(cfg, max_batch, device, f"image-semantic-{prompt_variant}")
        self.prompt = user_prompt or SEMANTIC_FILTER_PROMPTS[prompt_variant]
        self.score_only = score_only
        self.keep_on_unparseable = keep_on_unparseable

    def process_data(self, tasks: list[ImageTask]) -> list[ImageTask]:
        for t, text in self.ask(tasks, self.prompt):
            verdict = parse_yes_no(text)
            t.semantic_pass = verdict  # recorded even in score-only mode
            keep = verdict if verdict is not None else self.keep_on_unparseable
            if not self.score_only and not keep:
                t.filtered_by = "semantic"
        return tasks


class ImageClassifierStage(CaptionFamilyStage):
    """Assigns ``task.label`` from a label set via a VLM answer."""

    max_new_tokens = 12

    def __init__(
        self,
        labels: tuple[str, ...] = ("photo", "illustration", "screenshot", "document"),
        *,
        cfg: VLMConfig = VLM_BASE,
        max_batch: int = 8,
        unknown_label: str = "unknown",
        device: str | torch.device = "cuda",
    ) -> None:
        if not labels:
            raise ValueError("labels must be non-empty")
        super().__init__(cfg, max_batch, device, "image-classifier")
        self.labels = labels
        self.unknown_label = unknown_label
        self.prompt = (
            "Classify this image into exactly one of these categories: "
            + ", ".join(labels)
            + ". Answer with only the category name."
        )

    def parse_label(self, text: str) -> str:
        t = text.strip().lower()
        # exact answer first; then longest label first, so 'clip art' isn't
        # shadowed by its substring 'art'
        for label in self.labels:
            if t == label.lower():
                return label
        for label in sorted(self.labels, key=len, reverse=True):
            if label.lower() in t:
                return label
        return self.unknown_label

    def process_data(self, tasks: list[ImageTask]) -> list[ImageTask]:
        for t, text in self.ask(tasks, self.prompt):
            t.label = self.parse_label(text)
        return tasks
