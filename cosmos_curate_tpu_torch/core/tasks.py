"""Pipeline task base class (port of ``cosmos_curate_tpu/core/tasks.py``).

The reference's scheduling weight, progress fraction and payload-size
accounting are read only by its runners, and come with their port (ROADMAP
queue A item 1).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PipelineTask:
    """Base class for units of work flowing between stages. Subclasses are
    plain picklable dataclasses."""
