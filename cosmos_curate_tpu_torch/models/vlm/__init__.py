from cosmos_curate_tpu_torch.models.vlm.engine import CaptionEngine, CaptionRequest, CaptionResult, SamplingConfig
from cosmos_curate_tpu_torch.models.vlm.model import VLM, VLM_BASE, VLM_TINY_TEST, VLMConfig
from cosmos_curate_tpu_torch.models.vlm.paged_kv import BlockAllocator, PoolExhausted
from cosmos_curate_tpu_torch.models.vlm.shared_engine import SharedCaptionEngine

__all__ = [
    "VLM",
    "VLMConfig",
    "VLM_BASE",
    "VLM_TINY_TEST",
    "BlockAllocator",
    "CaptionEngine",
    "CaptionRequest",
    "CaptionResult",
    "PoolExhausted",
    "SamplingConfig",
    "SharedCaptionEngine",
]
