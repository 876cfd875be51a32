"""Host-side token sampling with the reference's full parameter surface.

Equivalent capability of the reference's VllmSamplingConfig
(pipelines/video/utils/data_model.py:900-931: presence/frequency/repetition
penalties, temperature, top_p, top_k, min_p, min_tokens, max_tokens) —
applied on host to one slot's logits row. Device work stays greedy-argmax
for the pure-greedy fast path; any non-default knob routes the row through
here (one numpy pass, no device round-trips).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SamplingConfig:
    max_new_tokens: int = 256
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled (nucleus)
    min_p: float = 0.0  # 0.0 = disabled
    repetition_penalty: float = 1.0  # 1.0 = disabled
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    min_tokens: int = 0  # suppress EOS until this many tokens generated
    # generation stops when any of these strings appears in the decoded
    # text; the match and everything after it is dropped (vLLM `stop`)
    stop: tuple[str, ...] = ()
    # None = unseeded (engine-shared rng); any int — including 0 — pins
    # this request's draws to a dedicated generator
    seed: int | None = None

    @property
    def needs_host_sampling(self) -> bool:
        """True when the device greedy-argmax result is insufficient."""
        return (
            self.temperature > 0.0
            or self.repetition_penalty != 1.0
            or self.presence_penalty != 0.0
            or self.frequency_penalty != 0.0
        )

    def needs_logits(self, num_generated: int) -> bool:
        return self.needs_host_sampling or num_generated < self.min_tokens


def apply_penalties(
    logits: np.ndarray,
    generated: list[int] | dict[int, int],
    cfg: SamplingConfig,
) -> np.ndarray:
    """Repetition / presence / frequency penalties over generated history
    (vLLM semantics: repetition divides positive logits and multiplies
    negative ones; presence subtracts once per seen token; frequency
    subtracts per occurrence).

    ``generated`` may be a token list or a precomputed ``{token: count}``
    map — hot loops maintain the map incrementally instead of re-uniquing
    the full prompt+output history every token."""
    if not generated or (
        cfg.repetition_penalty == 1.0
        and cfg.presence_penalty == 0.0
        and cfg.frequency_penalty == 0.0
    ):
        return logits
    logits = logits.astype(np.float64).copy()
    if isinstance(generated, dict):
        seen = np.fromiter(generated.keys(), np.int64, len(generated))
        counts = np.fromiter(generated.values(), np.int64, len(generated))
    else:
        seen, counts = np.unique(np.asarray(generated, np.int64), return_counts=True)
    in_range = (seen >= 0) & (seen < logits.shape[-1])
    seen = seen[in_range]
    counts = counts[in_range]
    if cfg.repetition_penalty != 1.0:
        vals = logits[seen]
        logits[seen] = np.where(
            vals > 0, vals / cfg.repetition_penalty, vals * cfg.repetition_penalty
        )
    if cfg.presence_penalty:
        logits[seen] -= cfg.presence_penalty
    if cfg.frequency_penalty:
        logits[seen] -= cfg.frequency_penalty * counts
    return logits


def sample_token(
    logits_row: np.ndarray,
    cfg: SamplingConfig,
    *,
    generated: list[int] | dict[int, int] | None = None,
    num_generated: int | None = None,
    eos_id: int | None = None,
    rng: np.random.Generator | None = None,
) -> int:
    """One token from one logits row under the full sampling config.

    ``generated`` is the penalty history (list or ``{token: count}`` map) —
    vLLM's repetition penalty covers prompt AND output tokens, so callers
    pass both. ``num_generated`` is the OUTPUT-token count governing
    min_tokens (defaults to len(generated) for standalone list use).
    ``eos_id`` is masked out while num_generated < min_tokens. Greedy
    (temperature<=0) still applies penalties and the EOS mask."""
    generated = generated or []
    if num_generated is None:
        num_generated = (
            int(sum(generated.values())) if isinstance(generated, dict) else len(generated)
        )
    logits = apply_penalties(np.asarray(logits_row), generated, cfg)
    if eos_id is not None and num_generated < cfg.min_tokens:
        logits = logits.astype(np.float64).copy()
        logits[eos_id] = -np.inf
    if cfg.temperature <= 0.0:
        return int(np.argmax(logits))
    scaled = logits.astype(np.float64) / cfg.temperature
    k = min(cfg.top_k, scaled.shape[-1]) if cfg.top_k > 0 else 0
    if 0 < k < scaled.shape[-1]:
        kth = np.partition(scaled, -k)[-k]
        scaled = np.where(scaled < kth, -np.inf, scaled)
    scaled = scaled - scaled.max()
    probs = np.exp(scaled)
    probs /= probs.sum()
    # vLLM filter order: top_p over the raw distribution, THEN min_p —
    # reversing it computes the nucleus over renormalized (inflated) probs
    if cfg.top_p < 1.0:
        order = np.argsort(probs)[::-1]
        csum = np.cumsum(probs[order])
        # smallest prefix with mass >= top_p
        cutoff = int(np.searchsorted(csum, cfg.top_p)) + 1
        mask = np.zeros_like(probs, bool)
        mask[order[:cutoff]] = True
        probs = np.where(mask, probs, 0.0)
    if cfg.min_p > 0.0:
        keep = probs >= cfg.min_p * probs.max()
        probs = np.where(keep, probs, 0.0)
    probs /= probs.sum()
    if rng is None:
        rng = _fallback_rng(cfg.seed)
    return int(rng.choice(len(probs), p=probs))


_FALLBACK_RNGS: dict[int, np.random.Generator] = {}


def _fallback_rng(seed: int) -> np.random.Generator:
    """Per-seed generator whose state ADVANCES across calls — a fresh
    default_rng(seed) per token would repeat the same draw every step."""
    rng = _FALLBACK_RNGS.get(seed)
    if rng is None:
        rng = _FALLBACK_RNGS[seed] = np.random.default_rng(seed)
    return rng
