"""Parquet to lance conversion (port of ``cosmos_curate_tpu/storage/lance_export.py``).

The pipelines write embeddings as parquet (``embeddings/<model>/<chunk>.parquet``
with ``clip_uuid`` and ``embedding``); where ``pylance`` is installed, this
module (or the ``export-lance`` command) turns them into one lance dataset
per model with the same columns. The directory walk and table assembly need
no lance; without it ``export_parquet_to_lance`` raises ``RuntimeError``
with the ``pip install pylance`` guidance. Host code: imports no torch.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def load_embedding_tables(src: str | Path) -> dict[str, Any]:
    """Read every embeddings parquet under ``src`` into one pyarrow table
    per model subdirectory (the layout ``ClipWriterStage`` emits:
    ``embeddings/<model>/<chunk>.parquet`` with clip_uuid + embedding)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    src = Path(src)
    tables: dict[str, Any] = {}
    groups: dict[str, list] = {}
    if any(src.glob("*.parquet")):  # src IS one model directory
        groups[src.name] = sorted(src.glob("*.parquet"))
    else:
        for sub in sorted(p for p in src.iterdir() if p.is_dir()):
            files = sorted(sub.glob("*.parquet"))
            if files:
                groups[sub.name] = files
    for model, files in groups.items():
        tables[model] = pa.concat_tables([pq.read_table(f) for f in files])
    return tables


def export_parquet_to_lance(
    src: str | Path, dest: str | Path, *, mode: str = "create"
) -> dict[str, int]:
    """Convert pipeline embeddings parquet output into lance dataset(s).

    ``src``: the run's ``embeddings/`` dir (or one model subdir).
    ``dest``: output root; each model becomes ``<dest>/<model>.lance``.
    Returns {dataset_path: num_rows}. Requires the ``lance`` package
    (``pip install pylance``) — raises with that guidance otherwise.
    """
    tables = load_embedding_tables(src)
    if not tables:
        raise FileNotFoundError(f"no embeddings parquet found under {src}")
    try:
        import lance
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise RuntimeError(
            "lance is not installed in this environment; run "
            "`pip install pylance` where the conversion should happen "
            "(the pipeline's parquet output is self-contained until then)"
        ) from e
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    written: dict[str, int] = {}
    for model, table in tables.items():
        uri = str(dest / f"{model}.lance")
        lance.write_dataset(table, uri, mode=mode)
        written[uri] = table.num_rows
        logger.info("wrote %d rows to %s", table.num_rows, uri)
    return written
