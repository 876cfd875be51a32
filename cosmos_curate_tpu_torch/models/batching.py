"""Power-of-two shape buckets (mirror of ``cosmos_curate_tpu/models/batching.py``).

The caption engine pads prefill row counts and prompt lengths to powers of
two, and the device pipeline pads micro-batches to their pow2 bucket.
PyTorch compiles nothing per shape, but the buckets still decide which rows
and cache positions a program touches, so the port keeps them exactly to
stay comparable with the reference.
"""

from __future__ import annotations

import numpy as np


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()



def pad_batch(x: np.ndarray) -> tuple[np.ndarray, int]:
    """Pad x's leading dim to the next power of two, repeating the last row
    (padded rows stay in-distribution). Returns (padded, original_n)."""
    n = x.shape[0]
    target = next_pow2(n)
    if n == 0 or target == n:
        return x, n
    return np.concatenate([x, np.broadcast_to(x[-1:], (target - n, *x.shape[1:]))]), n
