"""Typed output writers over the storage helpers (port of
``cosmos_curate_tpu/storage/writers.py``: json and parquet, which the split
pipeline's writer and summary use, and csv, the dedup summary's). All go
through ``write_bytes``, so local writes are atomic.
"""

from __future__ import annotations

import csv
import io
import json
from typing import Any, Iterable, Mapping

import numpy as np

from cosmos_curate_tpu_torch.storage.client import write_bytes


class _NumpyJSONEncoder(json.JSONEncoder):
    def default(self, o: Any) -> Any:
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if hasattr(o, "hex") and hasattr(o, "int"):  # uuid.UUID
            return str(o)
        return super().default(o)


def write_json(path: str, obj: Any) -> None:
    write_bytes(path, json.dumps(obj, indent=2, cls=_NumpyJSONEncoder).encode())


def write_parquet(path: str, columns: Mapping[str, Any]) -> None:
    """Columnar write; ``pyarrow`` is imported only here."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = pa.table(dict(columns))
    sink = io.BytesIO()
    pq.write_table(table, sink)
    write_bytes(path, sink.getvalue())


def write_csv(path: str, rows: Iterable[Mapping[str, Any]], fieldnames: list[str]) -> None:
    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=fieldnames)
    writer.writeheader()
    for row in rows:
        writer.writerow(row)
    write_bytes(path, buf.getvalue().encode())
