"""Captioning / filtering prompt variants.

Equivalent capability of the reference's prompt library
(cosmos_curate/models/prompts.py, pipelines/common/filter_prompts.py):
named prompt variants for captioning, refinement, and semantic filtering.
Text is our own.
"""

from __future__ import annotations

CAPTION_PROMPTS: dict[str, str] = {
    "default": (
        "Describe this video clip in detail: the subjects, their actions, "
        "the setting, camera motion, and lighting."
    ),
    "av": (
        "Describe this driving scene: road layout, vehicles, pedestrians, "
        "traffic signals, weather, and the ego vehicle's maneuver."
    ),
    "short": "Write a one-sentence description of this video clip.",
    "factual": (
        "List only directly observable facts about this video clip, "
        "without speculation."
    ),
}

REFINEMENT_PROMPT = (
    "Rewrite the following video description to be clearer and more "
    "specific, keeping every stated fact: "
)

ENHANCE_PROMPT = (
    "Improve this caption's fluency and detail without inventing facts: "
)

SEMANTIC_FILTER_PROMPTS: dict[str, str] = {
    "default": (
        "Does this video clip contain clear, well-lit, non-synthetic "
        "real-world footage? Answer yes or no."
    ),
    "overlay-text": (
        "Does this video clip contain burned-in overlay text, subtitles, "
        "or watermarks? Answer yes or no."
    ),
    "image-default": (
        "Is this a clear, well-lit, non-synthetic real-world photograph? "
        "Answer yes or no."
    ),
}


def get_caption_prompt(variant: str) -> str:
    try:
        return CAPTION_PROMPTS[variant]
    except KeyError:
        raise KeyError(
            f"unknown caption prompt variant {variant!r}; have {sorted(CAPTION_PROMPTS)}"
        ) from None
