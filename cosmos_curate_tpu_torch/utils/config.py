"""Config-file pipeline invocation (port of
``cosmos_curate_tpu/utils/config.py``).

``load_pipeline_config``: a YAML or JSON file whose keys map onto a
pipeline args dataclass (``SplitPipelineArgs`` for ``local split
--config``). PyYAML is imported only for a ``.yaml`` / ``.yml`` file.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Type, TypeVar

T = TypeVar("T")


def load_pipeline_config(path: str, args_cls: Type[T]) -> T:
    text = Path(path).read_text()
    if path.endswith((".yaml", ".yml")):
        import yaml

        data = yaml.safe_load(text)
    else:
        data = json.loads(text)
    if not isinstance(data, dict):
        raise ValueError(f"config {path} must be a mapping, got {type(data).__name__}")
    names = {f.name for f in dataclasses.fields(args_cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"unknown config keys for {args_cls.__name__}: {sorted(unknown)}")
    # Lists in JSON/YAML arrive for tuple-typed fields; coerce.
    kwargs = {}
    for f in dataclasses.fields(args_cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if isinstance(v, list) and "tuple" in str(f.type):
            v = tuple(v)
        kwargs[f.name] = v
    return args_cls(**kwargs)
