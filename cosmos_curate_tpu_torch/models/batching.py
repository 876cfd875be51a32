"""Power-of-two shape buckets (mirror of ``cosmos_curate_tpu/models/batching.py``).

The caption engine pads prefill row counts and prompt lengths to powers of
two, and the device pipeline pads micro-batches to their pow2 bucket.
PyTorch compiles nothing per shape, but the buckets still decide which rows
and cache positions a program touches, so the port keeps them exactly to
stay comparable with the reference.
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()

