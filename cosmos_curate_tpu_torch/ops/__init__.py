"""Attention ops of the port: each wraps a hand-written CUDA kernel
(``csrc/``) and keeps its plain PyTorch version beside it."""

from __future__ import annotations


def kernels():
    """name -> CudaKernel for every kernel the port has, each carrying its
    ``launches`` counter."""
    from cosmos_curate_tpu_torch.ops.decode_attention import DECODE_KERNEL
    from cosmos_curate_tpu_torch.ops.flash_attention import FLASH_KERNEL
    from cosmos_curate_tpu_torch.ops.paged_attention import (
        PAGED_DECODE_KERNEL,
        PAGED_PREFILL_KERNEL,
    )
    from cosmos_curate_tpu_torch.ops.prefill_attention import PREFILL_KERNEL

    return {
        "paged_decode": PAGED_DECODE_KERNEL,
        "paged_prefill": PAGED_PREFILL_KERNEL,
        "prefill": PREFILL_KERNEL,
        "decode": DECODE_KERNEL,
        "flash": FLASH_KERNEL,
    }
