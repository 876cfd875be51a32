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


class ModelInterface(abc.ABC):
    """Base class for all models driven by pipeline stages."""

    @property
    def device_pipeline(self):
        """The model's DevicePipeline after ``setup()``, else None. None
        also for models whose device work runs elsewhere (the caption
        engine's continuous-batching loop is its own dispatch point)."""
        return getattr(self, "_pipeline", None)

    @property
    @abc.abstractmethod
    def model_id_names(self) -> list[str]:
        """Weight-registry ids this model needs."""

    @abc.abstractmethod
    def setup(self) -> None:
        """Load weights and build the inference callable (inside a worker)."""
