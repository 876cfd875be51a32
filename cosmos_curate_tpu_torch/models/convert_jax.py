"""Weights bridge: a flax parameter tree of the JAX package -> the port's
``state_dict``.

The port names its modules after the flax ones, so the map is mechanical:

- path parts ``layer_{i}`` / ``block_{i}`` -> ``layers.{i}`` / ``blocks.{i}``,
  ``layers_{i}`` (an ``nn.Sequential`` child, e.g. the projector) -> ``{i}``;
- Dense ``kernel [in, out]`` -> ``Linear.weight [out, in]`` (a fused
  kernel, such as the Qwen tower's ``qkv``, transposes whole, so its
  outputs keep their ``(3, heads, head_dim)`` split order);
- Conv ``kernel`` HWIO -> ``Conv2d.weight`` OIHW, a 1-D conv's WIO ->
  ``Conv1d.weight`` OIW, and a 3-D conv's ``[kt, kh, kw, in, out]`` ->
  ``Conv3d.weight [out, in, kt, kh, kw]``;
- ``Embed.embedding`` -> ``Embedding.weight`` (T5's ``shared``, the CLIP
  text tower's ``tok_embed``), and T5's bucket table ``rel_bias.embedding``
  -> ``rel_bias.weight``;
- LayerNorm / RMSNorm ``scale`` -> ``weight`` (``bias`` stays ``bias``);
  T5's RMS norms name theirs ``weight`` already, and it stays;
- raw params (``cls``, ``pos_embed``, the pooler's ``query`` and
  ``time_embed``, InternVideo2's LayerScale ``ls1`` / ``ls2``, the MoE
  experts ``moe/gate_up [E, D, 2H]`` and ``moe/down [E, H, D]``, the CLIP
  text tower's ``pos_embed [1, max_len, width]``) keep
  their names and layout (the MoE router is a Dense: its ``[D, E]``
  kernel transposes); ``load_state_dict`` casts each value to its
  parameter's dtype (bf16 for the experts of a bf16 model);
- other module names carry over as they are: the video embedder's
  ``vit/...`` and ``pooler/t{i}/...`` become ``vit....`` and
  ``pooler.t{i}....``, because the port's pooler names its blocks ``t{i}``.

Leaves may be numpy arrays or anything ``numpy.asarray`` accepts; boxed
leaves (flax's partitioning metadata) are unboxed through their ``value``.
Values stay fp32, as the flax params are.

``state_dict_to_flax`` is the inverse, for the checkpoint writer
(``registry.save_params``). Names alone do not decide it (a ``weight`` may
have been a ``kernel``, a ``scale``, an ``embedding`` or a ``weight``), so
each leaf is resolved by the type of the module that owns it: a
``Linear`` or conv ``weight`` was a kernel (transposed back by rank), an
``Embedding``'s was an ``embedding``, a norm's was a ``scale``, a module
that names its flax leaf itself (``FLAX_WEIGHT_NAME``: T5's norms keep
``weight``, its bucket table was an ``embedding``) gives that name, and
every other leaf keeps its name. Path parts go back as ``layers.{i}`` ->
``layer_{i}``, ``blocks.{i}`` -> ``block_{i}`` and a bare ``{i}`` ->
``layers_{i}``.
"""

from __future__ import annotations

import re
import warnings
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"^(layer|block|layers)_(\d+)$")
_PLURAL = {"layer": "layers", "block": "blocks", "layers": ""}


def _module_name(part: str) -> str:
    m = _INDEXED.match(part)
    if m is None:
        return part
    prefix = _PLURAL[m.group(1)]
    return f"{prefix}.{m.group(2)}" if prefix else m.group(2)


# a flax kernel's axes in its torch weight's order, by rank
_WEIGHT_FROM_KERNEL = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _leaf(name: str, value) -> tuple[str, torch.Tensor]:
    """The torch name and value of one flax leaf: a new contiguous fp32
    tensor, its transposes done by torch's multithreaded copy (the leaves of
    a read checkpoint are read-only arrays over msgpack's bytes)."""
    arr = np.asarray(getattr(value, "value", value), dtype=np.float32)
    if any(s < 0 for s in arr.strides):  # torch takes no negative strides
        arr = arr.copy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a read-only array: only read, into the copy below
        t = torch.from_numpy(arr) if arr.ndim else torch.tensor(arr)
    if name == "kernel":
        if arr.ndim not in _WEIGHT_FROM_KERNEL:
            raise ValueError(f"kernel of rank {arr.ndim} has no torch layout here")
        return "weight", t.permute(_WEIGHT_FROM_KERNEL[arr.ndim]).clone(memory_format=torch.contiguous_format)
    return ("weight" if name in ("embedding", "scale") else name), t.clone(memory_format=torch.contiguous_format)


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
                name, t = _leaf(str(key), value)
                out[".".join(p for p in prefix + [name] if p)] = t

    walk(tree, [])
    return out


_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.RMSNorm)
_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
# the inverse of ``_leaf``'s kernel layouts, by the torch weight's rank
_KERNEL_FROM_WEIGHT = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _is_norm(module: nn.Module) -> bool:
    """A norm of torch's or of the port's own (``LayerNorm``, the RMS
    norms): a module whose class name ends in ``Norm``."""
    return isinstance(module, _NORMS) or type(module).__name__.endswith("Norm")


def _flax_leaf(module: nn.Module, name: str, value: torch.Tensor) -> tuple[str, np.ndarray]:
    arr = value.detach().to(device="cpu", dtype=torch.float32).numpy()
    if name != "weight":
        return name, arr
    if hasattr(module, "FLAX_WEIGHT_NAME"):
        return module.FLAX_WEIGHT_NAME, arr
    if isinstance(module, (nn.Linear, *_CONVS)):
        return "kernel", arr.transpose(_KERNEL_FROM_WEIGHT[arr.ndim])
    if isinstance(module, nn.Embedding):
        return "embedding", arr
    if _is_norm(module):
        return "scale", arr
    return name, arr


def _flax_path(parts: list[str]) -> list[str]:
    out: list[str] = []
    for part in parts:
        if part.isdigit():
            if out and out[-1] in ("layers", "blocks"):
                out[-1] = f"{out[-1][:-1]}_{part}"
            else:
                out.append(f"layers_{part}")
        else:
            out.append(part)
    return out


def state_dict_to_flax(module: nn.Module, state_dict: Mapping[str, torch.Tensor] | None = None) -> dict:
    """The flax parameter tree (``{"params": {...}}`` of fp32 numpy arrays)
    that ``flax_to_state_dict`` maps onto ``state_dict`` (``module``'s own
    by default): ``flax_to_state_dict(state_dict_to_flax(m, sd)) == sd``."""
    if state_dict is None:
        state_dict = module.state_dict()
    tree: dict = {}
    for key, value in state_dict.items():
        owner, _, name = key.rpartition(".")
        leaf, arr = _flax_leaf(module.get_submodule(owner), name, value)
        node = tree
        for part in _flax_path(owner.split(".") if owner else []):
            node = node.setdefault(part, {})
        if leaf in node:
            raise ValueError(f"two parameters map onto flax leaf {key!r}")
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


def load_flax_params(module: torch.nn.Module, tree) -> None:
    """Copy a flax param tree into ``module`` (strict: every parameter of
    both sides must be matched)."""
    module.load_state_dict(flax_to_state_dict(tree), strict=True)
