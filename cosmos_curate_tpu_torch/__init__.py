"""PyTorch/CUDA port of cosmos_curate_tpu.

The JAX package ``cosmos_curate_tpu`` is the frozen reference; this package
mirrors its module paths (``cosmos_curate_tpu/models/vlm/engine.py`` ->
``cosmos_curate_tpu_torch/models/vlm/engine.py``) and imports nothing of it,
nor jax or flax. Every TPU kernel on a ported path is a hand-written Hopper
(sm_90a) CUDA kernel under ``csrc/``, built on first use by ``ops/_build.py``.

Entry points run on the GPU (``device="cuda"``) unless the caller asks for
the CPU; on a CPU tensor each kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
