"""Captioning stages: CPU prep + the GPU engine stage (port of
``cosmos_curate_tpu/pipelines/video/stages/captioning.py``).

The prep stage (``CaptionPrepStage``, in caption_prep.py, re-exported
here) cuts each clip into caption windows (``compute_windows``) and
samples each window's frames; the caption stage streams every window
of every clip through the process-level shared ``CaptionEngine``
(models/vlm/shared_engine.py) with continuous batching, optionally with a
second refinement pass per window.

Served flavors (models/vlm/model.py): the repository's ``base`` and
``tiny-test``, the dense Qwen-VL flavors ``qwen2vl-2b``, ``qwen25vl-7b``
and ``qwen-chat-tiny-test``, and the Qwen3 MoE flavors ``qwen3vl-moe-a3b``,
``qwen3moe-a3b-lm`` (text only: a request that carries frames is refused)
and ``qwen3moe-tiny-test``. The converted-checkpoint flavors serve the
checkpoint's own vocabulary (``HFVocabTokenizer`` over the staged
``vocab.json`` / ``merges.txt``, local files only) and its chat template
(models/vlm/chat.py). The engine stage runs on ``device="cuda"``
unless the caller asks for the CPU. Each engine drive opens the
reference's ``caption.submit`` and ``caption.engine`` spans (the latter
carries the drive's ``caption.*`` phase attributes) and folds its phases
into stage_timer's caption aggregate; the engine counters the stage writes
into ``task.stage_perf`` stay. The engine synchronises at its own phase
boundaries, so the spans add no device synchronisation.
"""

from __future__ import annotations

import itertools
import time

import torch

from cosmos_curate_tpu_torch.core.model import ModelInterface, model_device
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import SplitPipeTask, Window
from cosmos_curate_tpu_torch.engine.metrics import get_metrics
from cosmos_curate_tpu_torch.models import registry
from cosmos_curate_tpu_torch.models.prompts import REFINEMENT_PROMPT, get_caption_prompt
from cosmos_curate_tpu_torch.models.tokenizer import HFVocabTokenizer, default_caption_tokenizer
from cosmos_curate_tpu_torch.models.vlm.chat import build_qwen_vl_chat
from cosmos_curate_tpu_torch.models.vlm.engine import CaptionEngine, CaptionRequest, SamplingConfig
from cosmos_curate_tpu_torch.models.vlm.model import VLM_BASE, VLMConfig, vlm_flavor
from cosmos_curate_tpu_torch.observability import stage_timer
from cosmos_curate_tpu_torch.observability.tracing import traced_span
from cosmos_curate_tpu_torch.models.vlm.shared_engine import SharedCaptionEngine
from cosmos_curate_tpu_torch.pipelines.video.stages.caption_prep import CaptionPrepStage  # noqa: F401  (re-export)
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


# Each stage instance is one engine OWNER: requests carry the stage's
# unique owner tag, so completions route back to the right drive and the
# shared engine's per-owner fairness and accounting have a stable identity
_OWNER_SEQ = itertools.count()


def _owner_tag(name: str) -> str:
    """A unique, human-readable engine-owner tag for one stage instance."""
    return f"{name}#{next(_OWNER_SEQ)}"


class _CaptionVLM(ModelInterface):
    MODEL_ID = "caption-vlm-tpu"

    def __init__(
        self,
        cfg: VLMConfig,
        max_batch: int,
        model_id: str | None = None,
        require_weights: bool = False,
        hf_chat: bool = False,
        specials: dict[str, int] | None = None,
        kv_lanes: tuple[tuple[int, int], ...] | None = None,
        text_only: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = model_device(device, "the caption stage")
        self.cfg = cfg
        self.max_batch = max_batch
        self.model_id = model_id or self.MODEL_ID
        self.require_weights = require_weights
        self.hf_chat = hf_chat
        self.specials = specials
        self.kv_lanes = kv_lanes
        self.text_only = text_only
        self.engine: CaptionEngine | None = None
        self._tokenizer = None

    @property
    def model_id_names(self) -> list[str]:
        return [self.model_id]

    @property
    def tokenizer(self):
        """The tokenizer this flavor's requests must be encoded with. A
        converted checkpoint's embedding is indexed by its own token ids, so
        hf_chat flavors read the staged ``vocab.json`` / ``merges.txt``
        (``HFVocabTokenizer``) and fail loudly without them; the others use
        the repository's caption tokenizer (trained BPE, else bytes)."""
        if self._tokenizer is None:
            if self.hf_chat:
                vocab = registry.find_model_file(self.model_id, "vocab.json")
                merges = registry.find_model_file(self.model_id, "merges.txt")
                if vocab is None or merges is None:
                    raise FileNotFoundError(
                        f"{self.model_id} is a converted-checkpoint flavor: stage its tokenizer files "
                        f"(vocab.json + merges.txt) under {registry.local_dir_for(self.model_id)}/; encoding "
                        "with the repository tokenizer would address the wrong embedding rows"
                    )
                self._tokenizer = HFVocabTokenizer.from_gpt2_files(vocab, merges, specials=self.specials)
            else:
                self._tokenizer = default_caption_tokenizer()
        return self._tokenizer

    def encode_prompt(self, user_text: str, *, has_vision: bool = True) -> tuple[list[int], list[int]]:
        """(prefix_ids, prompt_ids) of a request in this flavor's format:
        the checkpoint's chat template for hf_chat flavors (the vision block
        splices between the two); otherwise all instruction text in the
        PREFIX, before the vision block, so the engine's shared-prefix KV
        cache prefills it once per prompt instead of once per window."""
        if has_vision and self.text_only:
            raise ValueError(
                f"{self.model_id} is a text-only flavor (no trained vision tower): frame-bearing stages "
                "cannot use it; pick a vision-language flavor"
            )
        if self.hf_chat:
            return build_qwen_vl_chat(self.tokenizer, user_text, has_vision=has_vision, specials=self.specials)
        return self.tokenizer.encode(user_text), []

    def setup(self) -> None:
        # the tokenizer BEFORE the engine: missing tokenizer files fail
        # setup, not the first inference; so do missing weights a flavor
        # requires, before a full-size model is built
        tokenizer = self.tokenizer
        if self.require_weights and registry.find_checkpoint(self.model_id) is None:
            raise RuntimeError(
                f"no staged weights for {self.model_id} under {registry.local_dir_for(self.model_id) / 'params.msgpack'}"
            )

        def loader(engine: CaptionEngine) -> dict[str, torch.Tensor]:
            def init(seed: int) -> dict[str, torch.Tensor]:
                return engine.model.state_dict()

            return registry.load_params(self.model_id, init, require=self.require_weights)

        self.engine = SharedCaptionEngine.get(
            self.cfg,
            model_id=self.model_id,
            max_batch=self.max_batch,
            kv_lanes=self.kv_lanes,
            tokenizer=tokenizer,
            loader=loader,
            device=self.device,
        )


def resolve_caption_model(
    cfg: VLMConfig | None, model_flavor: str | None, max_batch: int, device: str | torch.device = "cuda"
) -> _CaptionVLM:
    """One resolution rule for every caption-family stage: an explicit
    flavor selects the full serving spec (architecture, weight id, whether
    staged weights are required, tokenizer and chat handling, default KV
    lanes); otherwise ``cfg`` (default ``VLM_BASE``) under the base weight
    id."""
    if cfg is not None and model_flavor is not None:
        raise ValueError("pass cfg OR model_flavor, not both")
    if model_flavor is not None:
        spec = vlm_flavor(model_flavor)
        return _CaptionVLM(
            spec.cfg,
            max_batch,
            model_id=spec.model_id,
            require_weights=spec.require_weights,
            hf_chat=spec.hf_chat,
            specials=dict(spec.specials) if spec.specials else None,
            kv_lanes=spec.kv_lanes,
            text_only=spec.text_only,
            device=device,
        )
    return _CaptionVLM(cfg or VLM_BASE, max_batch, device=device)


class CaptionStage(Stage[SplitPipeTask, SplitPipeTask]):
    """GPU stage: continuous-batching captioning of every clip window, on
    ``device`` ("cuda" unless the caller asks for the CPU)."""

    def __init__(
        self,
        *,
        prompt_variant: str = "default",
        cfg: VLMConfig | None = None,
        max_batch: int = 8,
        max_new_tokens: int = 128,
        refine: bool = False,
        model_flavor: str | None = None,
        stage_batch_size: int = 32,
        device: str | torch.device = "cuda",
    ) -> None:
        self.prompt_variant = prompt_variant
        self.prompt_text = get_caption_prompt(prompt_variant)
        self.max_new_tokens = max_new_tokens
        self.refine = refine
        # this stage's engine-owner identity: requests are tagged with it,
        # completions route back by it
        self.owner = _owner_tag(f"caption-{prompt_variant}")
        self._model = resolve_caption_model(cfg, model_flavor, max_batch, device)
        # a small-context flavor clamps generation instead of refusing
        # requests (half the context stays for vision + prompt)
        if self.max_new_tokens >= self._model.cfg.max_seq // 2:
            self.max_new_tokens = self._model.cfg.max_seq // 2
        self._refined_ids: set[str] = set()  # refinement bookkeeping
        # deep batches feed the continuous batch: with one task per call,
        # every window would decode alone
        self._stage_batch_size = max(1, stage_batch_size)
        self._encoded_prompt: tuple[list[int], list[int]] | None = None
        self._sampling = SamplingConfig(max_new_tokens=self.max_new_tokens)

    @property
    def model(self) -> ModelInterface:
        return self._model

    @property
    def resources(self) -> Resources:
        return Resources(cpus=1.0, entire_gpu_host=self._model.device.type == "cuda")

    @property
    def batch_size(self) -> int:
        return self._stage_batch_size

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        engine = self._model.engine
        if engine is None:
            raise RuntimeError("CaptionStage.process_data before setup()")
        t_start = time.monotonic()
        phases0 = engine.phase_seconds
        stats0 = self._engine_counts(engine)
        windows: dict[str, Window] = {}
        with traced_span("caption.submit", stage=self.name):
            for task in tasks:
                for clip in task.video.clips:
                    for w_i, win in enumerate(clip.windows):
                        if win.frames is None:
                            continue
                        rid = f"{clip.uuid}-{w_i}"
                        windows[rid] = win
                        # non-blocking: the engine preps (vision encode +
                        # embedding) in its background thread while
                        # run_until_complete below decodes
                        engine.add_request(self._make_request(rid, win))
        if not windows:
            return tasks
        with traced_span("caption.engine", stage=self.name) as span:
            results = engine.run_until_complete(owner=self.owner)
            phases = self._phase_delta(engine, phases0, stats0, time.monotonic() - t_start)
            phases["requests"] = len(results)
            for k, v in phases.items():
                span.set_attribute(f"caption.{k}", round(v, 4) if isinstance(v, float) else v)
        stage_timer.record_caption_phases(self.name, phases)
        try:
            get_metrics().observe_caption_owners(engine.owner_stats())
        except Exception:  # metrics must never take down the caption path
            logger.exception("caption owner gauges failed")
        for res in results:
            win = windows.get(res.request_id)
            if win is not None:
                win.caption[self.prompt_variant] = res.text
        logger.info(
            "captioned %d windows at %.1f output tok/s (prefill %.2fs decode %.2fs idle %.2fs; "
            "prefix hits %d, %d prefill tokens saved)",
            len(results), engine.tokens_per_second, phases["prefill_s"], phases["decode_s"],
            phases["idle_s"], phases["prefix_cache_hits"], phases["prefix_tokens_saved"],
        )
        for task in tasks:
            task.stage_perf["caption_tokens_per_s"] = engine.tokens_per_second
            task.stage_perf["caption_prefix_cache_hits"] = phases["prefix_cache_hits"]
            task.stage_perf["caption_engine_idle_s"] = round(phases["idle_s"], 4)
            task.stage_perf["caption_kv_blocks_used"] = engine.kv_blocks_used
            task.stage_perf["caption_prefix_block_refs"] = phases["prefix_block_refs"]
            task.stage_perf["caption_decode_tokens"] = phases["decode_tokens"]
        return tasks

    def _engine_counts(self, engine: CaptionEngine) -> dict:
        return {
            "prefill_tokens": engine.prefill_tokens,
            "prefix_cache_hits": engine.prefix_cache_hits,
            "prefix_cache_misses": engine.prefix_cache_misses,
            "prefix_tokens_saved": engine.prefix_tokens_saved,
            "vision_encodes": engine.vision_encodes,
            "vision_reuses": engine.vision_reuses,
            "prefix_block_refs": engine.prefix_block_refs,
            "kv_cow_copies": engine.kv_cow_copies,
            "interleaved_steps": engine.interleaved_decode_steps,
            "paged_kernel_steps": engine.paged_kernel_steps,
            # per OWNER, not engine-wide: under a shared engine another
            # stage's tokens decode inside this drive's window
            "decode_tokens": engine.owner_decode_tokens.get(self.owner, 0),
        }

    def _phase_delta(self, engine: CaptionEngine, phases0: dict, stats0: dict, wall: float) -> dict:
        """Per-phase and per-counter deltas over this drive. Counters are
        engine-wide: under a shared engine another stage's concurrent drive
        bleeds in. ``idle_s`` is wall minus the device phases."""
        phases = {k: engine.phase_seconds[k] - phases0[k] for k in engine.phase_seconds}
        now = self._engine_counts(engine)
        counts = {k: now[k] - stats0[k] for k in now}
        busy = phases["prefill_s"] + phases["decode_s"]
        return {
            **phases,
            **counts,
            "wall_s": wall,
            "idle_s": max(0.0, wall - busy),
            # occupancy gauges (absolute, not deltas) and the owner, for the
            # run report's per-owner accounting
            "owner": self.owner,
            "kv_blocks_total": engine.kv_blocks_total,
            "kv_blocks_peak": engine.kv_blocks_used_peak,
            "kv_blocks_used": engine.kv_blocks_used,
        }

    def _make_request(self, rid: str, win: Window) -> CaptionRequest:
        if self._encoded_prompt is None:
            self._encoded_prompt = self._model.encode_prompt(self.prompt_text)
        prefix_ids, prompt_ids = self._encoded_prompt
        sampling = self._sampling
        on_complete = None
        if self.refine:

            def on_complete(text: str, _rid=rid, _win=win) -> CaptionRequest | None:
                if _rid in self._refined_ids:
                    return None
                self._refined_ids.add(_rid)
                pre, ids = self._model.encode_prompt(REFINEMENT_PROMPT + text)
                return CaptionRequest(
                    request_id=_rid,
                    prefix_ids=pre,
                    prompt_ids=ids,
                    frames=_win.frames,
                    frame_fps=_win.frame_fps,
                    sampling=sampling,
                    on_complete=on_complete,
                    # the refinement prefix bakes in the window's own
                    # caption: unique per window, so caching it would thrash
                    # the shared-prefix LRU without ever hitting
                    share_prefix=False,
                )

        return CaptionRequest(
            request_id=rid,
            prefix_ids=list(prefix_ids),
            prompt_ids=list(prompt_ids),
            frames=win.frames,
            frame_fps=win.frame_fps,
            sampling=sampling,
            on_complete=on_complete,
            owner=self.owner,
        )
