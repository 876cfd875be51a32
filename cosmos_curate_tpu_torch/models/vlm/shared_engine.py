"""Process-level shared caption engine registry: cross-job continuous
batching (port of ``cosmos_curate_tpu/models/vlm/shared_engine.py``).

Engines are registered per served checkpoint, architecture and device, so every caption-family stage and every concurrent pipeline in the
process submits into ONE engine per served model. Requests carry an
``owner`` tag and the engine's admission interleaves owners fairly, so two
pipelines decode in one continuous batch, and weights + the KV block pool
exist once per model.

The key excludes serving geometry (max_batch, kv_lanes, block_size):
sharing one engine across stages that ask for different batch sizes is the
point, so the first creator's geometry wins and later getters join it.

Where the reference keys engines on the JAX device mesh, the port keys them
on the torch device (type, index) and the engine's ``paged_attention``
mode; the sharding geometry is always ``()``, because the port's engine
refuses ``mesh`` (ROADMAP queue A item 7).

Weights: ``get``'s ``loader`` runs once, on the engine that ``setup`` has
built, and its result is loaded into the model that serves
(``CaptionEngine.load_weights``). The reference assigns ``engine.params``
after setup, which its jitted programs read per call; the port's engine
builds its module from ``params`` inside setup, so an assignment there
would leave the seeded weights serving.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable

import torch

from cosmos_curate_tpu_torch.models.vlm.engine import CaptionEngine
from cosmos_curate_tpu_torch.models.vlm.model import VLMConfig
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass(frozen=True)
class EngineKey:
    """What must match for two callers to share one engine: the served
    checkpoint (model_id: the same architecture under two weight ids must
    NOT share), the architecture (cfg), the device, the attention program
    family, and the sharding geometry. The reference's compute dtype is
    not a key: the port's engine serves in bf16 only."""

    model_id: str
    cfg: VLMConfig
    device: tuple
    paged_attention: str = "auto"
    geometry: tuple = ()


def _device_key(device: str | torch.device) -> tuple:
    dev = torch.device(device)
    index = dev.index
    if dev.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    return dev.type, index


class SharedCaptionEngine:
    """The process-level registry. All methods are classmethods: there is
    exactly one registry per process."""

    _lock = threading.Lock()
    _engines: dict[EngineKey, CaptionEngine] = {}
    # per-key build locks: engine setup + weight loading can take long, and
    # must not stall registry reads or a DIFFERENT model's creation
    _building: dict[EngineKey, threading.Lock] = {}

    @classmethod
    def key_for(
        cls,
        cfg: VLMConfig,
        model_id: str,
        device: str | torch.device = "cuda",
        paged_attention: str = "auto",
    ) -> EngineKey:
        return EngineKey(model_id, cfg, _device_key(device), paged_attention)

    @classmethod
    def get(
        cls,
        cfg: VLMConfig,
        *,
        model_id: str,
        max_batch: int = 8,
        kv_lanes: tuple | None = None,
        tokenizer: Any = None,
        async_prep: bool = True,
        loader: Callable[[CaptionEngine], Any] | None = None,
        device: str | torch.device = "cuda",
        paged_attention: str = "auto",
    ) -> CaptionEngine:
        """The shared engine for (model, device, attention mode),
        built and set up on first use. ``loader`` (called once, with the
        set-up engine) returns the ``state_dict`` to serve, which is loaded
        into the serving model; None keeps the seeded init."""
        key = cls.key_for(cfg, model_id, device, paged_attention)

        def existing() -> CaptionEngine | None:
            engine = cls._engines.get(key)
            if engine is None:
                return None
            actual = [(lane.length, lane.n_slots) for lane in engine.lanes]
            wanted = sorted((int(a), int(b)) for a, b in kv_lanes) if kv_lanes is not None else None
            if (wanted is not None and wanted != actual) or (wanted is None and max_batch != engine.max_batch):
                logger.info(
                    "sharing caption engine %s: requested geometry (max_batch=%s, kv_lanes=%s) differs "
                    "from the creator's lanes %s (geometry is fixed at first creation)",
                    model_id, max_batch, kv_lanes, actual,
                )
            return engine

        with cls._lock:
            engine = existing()
            if engine is not None:
                return engine
            build_lock = cls._building.setdefault(key, threading.Lock())
        # build OUTSIDE the registry lock: only same-key callers wait
        with build_lock:
            with cls._lock:
                engine = existing()
            if engine is not None:
                return engine
            engine = CaptionEngine(
                cfg,
                max_batch=max_batch,
                tokenizer=tokenizer,
                kv_lanes=kv_lanes,
                # production engines prep in the background so vision
                # encoding of request N+1 overlaps decode of request N
                async_prep=async_prep,
                paged_attention=paged_attention,
                device=device,
            )
            engine.setup()
            if loader is not None:
                engine.load_weights(loader(engine))
            with cls._lock:
                cls._engines[key] = engine
                cls._building.pop(key, None)
            return engine

    @classmethod
    def adopt(cls, engine: CaptionEngine, *, cfg: VLMConfig, model_id: str) -> None:
        """Register an externally built engine, so a stage shares it instead
        of doubling weight memory. The engine's own device and attention
        mode decide its slot."""
        with cls._lock:
            key = cls.key_for(cfg, model_id, engine.device, engine.paged_attention)
            cls._engines[key] = engine

    @classmethod
    def stats(cls) -> dict:
        """Registry-wide occupancy + per-owner gauges, keyed by model_id."""
        with cls._lock:
            engines = dict(cls._engines)
        return {
            key.model_id: {
                "kv_blocks_used": engine.kv_blocks_used,
                "kv_blocks_total": engine.kv_blocks_total,
                "prefix_block_refs": engine.prefix_block_refs,
                "interleaved_decode_steps": engine.interleaved_decode_steps,
                "owners": engine.owner_stats(),
            }
            for key, engine in engines.items()
        }

    @classmethod
    def reset(cls) -> None:
        """Drop every registered engine. Engines are shut down so prep
        threads stop and prefix-cache block references release. A build in
        flight keeps its per-key lock (it pops its own entry when it
        registers), so a ``get`` that arrives meanwhile waits for it
        instead of building a second engine."""
        with cls._lock:
            engines = list(cls._engines.values())
            cls._engines.clear()
        for engine in engines:
            try:
                engine.shutdown()
            except Exception:  # a wedged prep thread must not fail teardown
                logger.exception("engine shutdown failed during registry reset")
