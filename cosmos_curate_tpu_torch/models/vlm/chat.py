"""Qwen chat-template prompts for converted checkpoints (port of
``cosmos_curate_tpu/models/vlm/chat.py``): the engine's ``(prefix_ids,
prompt_ids)`` pair, so the vision embeddings splice where the template puts
the image. Use with :class:`~cosmos_curate_tpu_torch.models.tokenizer.
HFVocabTokenizer` (the checkpoint's exact ids).
"""

from __future__ import annotations

from cosmos_curate_tpu_torch.models.tokenizer import QWEN2_SPECIAL_TOKENS

DEFAULT_SYSTEM = "You are a helpful assistant."


def build_qwen_vl_chat(
    tokenizer,
    user_text: str,
    *,
    system: str = DEFAULT_SYSTEM,
    has_vision: bool = True,
    specials: dict[str, int] | None = None,
) -> tuple[list[int], list[int]]:
    """Token ids of one captioning turn in Qwen2(-VL)'s chat template, as
    ``(prefix_ids, prompt_ids)``; the engine puts the vision embeddings
    between them, in place of the template's ``<|image_pad|>`` run::

        <|im_start|>system\\n{system}<|im_end|>\\n
        <|im_start|>user\\n<|vision_start|>[VISION]<|vision_end|>{text}<|im_end|>\\n
        <|im_start|>assistant\\n

    Generation stops at ``<|im_end|>``: make it the engine tokenizer's
    ``eos_id`` (HFVocabTokenizer's default)."""
    sp = specials or QWEN2_SPECIAL_TOKENS
    im_start, im_end = sp["<|im_start|>"], sp["<|im_end|>"]
    nl = tokenizer.encode("\n")
    prefix = (
        [im_start] + tokenizer.encode("system\n" + system) + [im_end] + nl + [im_start] + tokenizer.encode("user\n")
    )
    suffix = []
    if has_vision:
        prefix = prefix + [sp["<|vision_start|>"]]
        suffix = [sp["<|vision_end|>"]]
    suffix = suffix + tokenizer.encode(user_text) + [im_end] + nl + [im_start] + tokenizer.encode("assistant\n")
    return prefix, suffix
