"""Weights bridge: a flax parameter tree of the JAX package -> the port's
``state_dict``.

The port names its modules after the flax ones, so the map is mechanical:

- path parts ``layer_{i}`` / ``block_{i}`` -> ``layers.{i}`` / ``blocks.{i}``,
  ``layers_{i}`` (an ``nn.Sequential`` child, e.g. the projector) -> ``{i}``;
- Dense ``kernel [in, out]`` -> ``Linear.weight [out, in]``;
- Conv ``kernel`` HWIO -> ``Conv2d.weight`` OIHW;
- ``Embed.embedding`` -> ``Embedding.weight``;
- LayerNorm / RMSNorm ``scale`` -> ``weight`` (``bias`` stays ``bias``);
- raw params (``cls``, ``pos_embed``, the pooler's ``query`` and
  ``time_embed``) keep their names;
- other module names carry over as they are: the video embedder's
  ``vit/...`` and ``pooler/t{i}/...`` become ``vit....`` and
  ``pooler.t{i}....``, because the port's pooler names its blocks ``t{i}``.

Leaves may be numpy arrays or anything ``numpy.asarray`` accepts; boxed
leaves (flax's partitioning metadata) are unboxed through their ``value``.
Values stay fp32, as the flax params are.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_INDEXED = re.compile(r"^(layer|block|layers)_(\d+)$")
_PLURAL = {"layer": "layers", "block": "blocks", "layers": ""}


def _module_name(part: str) -> str:
    m = _INDEXED.match(part)
    if m is None:
        return part
    prefix = _PLURAL[m.group(1)]
    return f"{prefix}.{m.group(2)}" if prefix else m.group(2)


def _leaf(name: str, value) -> tuple[str, np.ndarray]:
    arr = np.asarray(getattr(value, "value", value), dtype=np.float32)
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim} has no torch layout here")
    if name in ("embedding", "scale"):
        return "weight", arr
    return name, arr


def flax_to_state_dict(tree) -> dict[str, torch.Tensor]:
    """Flatten a flax param tree (``{"params": {...}}`` or the inner dict)
    into the port's ``state_dict`` (fp32, contiguous CPU tensors)."""
    if isinstance(tree, Mapping) and set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix: list[str]) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, prefix + [_module_name(str(key))])
            else:
                name, arr = _leaf(str(key), value)
                path = ".".join(p for p in prefix + [name] if p)
                out[path] = torch.tensor(np.ascontiguousarray(arr))

    walk(tree, [])
    return out


def load_flax_params(module: torch.nn.Module, tree) -> None:
    """Copy a flax param tree into ``module`` (strict: every parameter of
    both sides must be matched)."""
    module.load_state_dict(flax_to_state_dict(tree), strict=True)
