"""Model interface: the contract between stages and the models they drive
(port of ``cosmos_curate_tpu/core/model.py``).

``model_id_names`` names the weights a model needs; ``setup()`` runs inside
the worker and must leave the model ready for inference (weights on the
device, dispatch path built).

Device-dispatch contract: a model does not read results back inline after
each call. ``setup()`` builds a ``models.device_pipeline.DevicePipeline``
and inference entry points dispatch through it, so the host's batch
building, host-to-device copies, device compute and readback overlap
across micro-batches.
"""

from __future__ import annotations

import abc

import torch


class ModelInterface(abc.ABC):
    """Base class for all models driven by pipeline stages."""

    @property
    def device_pipeline(self):
        """The model's DevicePipeline after ``setup()``, else None. None
        also for models whose device work runs elsewhere (the caption
        engine's continuous-batching loop is its own dispatch point)."""
        return getattr(self, "_pipeline", None)

    @property
    def pin_to_single_worker(self) -> bool:
        """Stages driving this model dispatch from ONE worker thread: a
        ``DevicePipeline``'s in-flight window and side streams are
        single-threaded, so submissions from several threads would
        interleave micro-batches and misalign results. The pipelined runner
        reads this marker; a model whose dispatch really is thread-safe may
        override it to allow fan-out."""
        return True

    @property
    @abc.abstractmethod
    def model_id_names(self) -> list[str]:
        """Weight-registry ids this model needs."""

    @abc.abstractmethod
    def setup(self) -> None:
        """Load weights and build the inference callable (inside a worker)."""


def model_device(device: str | torch.device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where CUDA is not
    available raises: a model never falls back to the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions on the CPU"
        )
    return device
