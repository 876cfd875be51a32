"""Pipeline task base class (port of ``cosmos_curate_tpu/core/tasks.py``).

Tasks carry the reference's accounting: a ``weight`` for balancing load
across workers, a ``fraction`` for progress when one input fans out into
many tasks (dynamic chunking), and ``get_major_size()`` for payload size.
The port's one-host runners read none of them; the multi-worker runners
that do come with ROADMAP queue A item 9.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, fields, is_dataclass
from typing import Any

import numpy as np


def estimate_major_size(obj: Any) -> int:
    """Best-effort deep size of the *payload* of an object graph, in bytes.

    Counts the dominant buffers (bytes, bytearray, memoryview, numpy arrays,
    strings) reachable from ``obj`` via dataclass fields, dicts, lists,
    tuples and sets. Cycle-safe."""
    seen: set[int] = set()
    total = 0
    stack = [obj]
    while stack:
        o = stack.pop()
        oid = id(o)
        if oid in seen or o is None:
            continue
        seen.add(oid)
        if isinstance(o, memoryview):
            total += o.nbytes
        elif isinstance(o, (bytes, bytearray)):
            total += len(o)
        elif isinstance(o, np.ndarray):
            total += o.nbytes
        elif isinstance(o, str):
            total += len(o)
        elif isinstance(o, dict):
            stack.extend(o.keys())
            stack.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset)):
            stack.extend(o)
        elif is_dataclass(o) and not isinstance(o, type):
            for f in fields(o):
                stack.append(getattr(o, f.name, None))
        elif hasattr(o, "get_major_size") and callable(o.get_major_size) and oid != id(obj):
            # nested objects that do their own accounting
            total += int(o.get_major_size())
        elif hasattr(o, "__dict__"):
            stack.extend(vars(o).values())
        else:
            total += sys.getsizeof(o, 0)
    return total


@dataclass
class PipelineTask:
    """Base class for units of work flowing between stages. Subclasses are
    plain picklable dataclasses."""

    @property
    def weight(self) -> float:
        """Relative scheduling weight; default 1 per task."""
        return 1.0

    @property
    def fraction(self) -> float:
        """Fraction of an original input this task represents (for
        progress). A stage that re-chunks one task into N emits tasks whose
        fractions sum to the parent's fraction."""
        return 1.0

    def get_major_size(self) -> int:
        """Approximate payload size in bytes."""
        return estimate_major_size(self)
