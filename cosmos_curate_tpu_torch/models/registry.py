"""Model-weights registry: where a model's checkpoint lives and how it is
loaded (port of ``cosmos_curate_tpu/models/registry.py``, the parts the
caption stage and the split writer call).

A model's weights are ``params.msgpack`` under
``$CURATE_MODEL_WEIGHTS_DIR/<model-id>/`` (the staging directory) or under
the repository's ``weights/<model-id>/`` (committed weights), staging first.
The file is the JAX package's checkpoint format: a flax parameter tree
serialized with ``msgpack`` (``registry.save_params`` writes it). The port
reads it with ``msgpack`` alone, imported only when a file exists, and
bridges it to its own ``state_dict`` through ``models/convert_jax.py``.
torch and the converter are imported where a checkpoint is read or a
module filled, not with this module: the split writer asks only for
``weights_provenance`` (a file hash), from a process that needs no torch.
Without a file, ``load_params`` falls back to the seeded init with a
warning (or raises when the caller requires real weights).

Not ported: pulling checkpoints or tokenizer files from remote storage
(``CURATE_WEIGHTS_URI``). Only local files are read; the caption BPE is
``weights/caption-tokenizer``.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable

import numpy as np

from cosmos_curate_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:
    import torch

logger = get_logger(__name__)

WEIGHTS_DIR_ENV = "CURATE_MODEL_WEIGHTS_DIR"
# weights committed with the repository, searched after the staging dir so
# a staged checkpoint always wins
REPO_WEIGHTS_DIR = Path(__file__).resolve().parent.parent.parent / "weights"


# model id -> description, filled by the model modules that register an id
# (the CLIP text towers and T5 so far)
_REGISTRY: dict[str, str] = {}


def register_model(model_id: str, description: str = "") -> None:
    _REGISTRY[model_id] = description


def registered_models() -> list[str]:
    return sorted(_REGISTRY)


def weights_root() -> Path:
    return Path(os.environ.get(WEIGHTS_DIR_ENV, Path(tempfile.gettempdir()) / "curate_model_weights"))


def local_dir_for(model_id: str) -> Path:
    return weights_root() / model_id


def find_model_file(model_id: str, filename: str) -> Path | None:
    """A staged or committed model file, staging dir first."""
    for root in (weights_root(), REPO_WEIGHTS_DIR):
        p = root / model_id / filename
        if p.exists():
            return p
    return None


def find_checkpoint(model_id: str) -> Path | None:
    return find_model_file(model_id, "params.msgpack")


_PROVENANCE_CACHE: dict[tuple[str, int], str] = {}


def weights_provenance(model_id: str) -> str:
    """Where ``model_id``'s weights would come from right now:
    ``"checkpoint:<sha256-12>"`` when a checkpoint is staged or committed,
    ``"random"`` otherwise (the seeded-init fallback ``load_params`` warns
    about). Only positive results are cached (keyed by path + mtime), so
    weights staged later in the process are picked up."""
    ckpt = find_checkpoint(model_id)
    if ckpt is None:
        return "random"
    try:
        key = (str(ckpt), ckpt.stat().st_mtime_ns)
    except OSError:
        return "random"
    cached = _PROVENANCE_CACHE.get(key)
    if cached is not None:
        return cached
    digest = hashlib.sha256()
    with ckpt.open("rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 22), b""):
            digest.update(chunk)
    prov = f"checkpoint:{digest.hexdigest()[:12]}"
    _PROVENANCE_CACHE[key] = prov
    return prov


# flax.serialization's msgpack extension codes of arrays and numpy scalars
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # numpy has no bfloat16: widen through torch
        import torch

        flat = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16).float().numpy()
        return flat.reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _restore_leaves(node):
    """Rejoin arrays flax split into chunks, and unwrap leaves that older
    checkpoints boxed as ``{"value": array}``."""
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    if set(node) == {"value"} and isinstance(node["value"], np.ndarray):
        return node["value"]
    return {k: _restore_leaves(v) for k, v in node.items()}


def read_flax_msgpack(data: bytes) -> dict:
    """A parameter tree serialized by ``flax.serialization.to_bytes``, as
    nested dicts of numpy arrays."""
    import msgpack

    return _restore_leaves(msgpack.unpackb(data, ext_hook=_ext_hook, raw=False))


def _assert_shapes_match(template: dict[str, torch.Tensor], restored: dict[str, torch.Tensor], model_id: str) -> None:
    """Raise ValueError naming the first parameter the checkpoint lacks,
    has in excess, or holds at another shape than the model."""
    missing = sorted(set(template) - set(restored))
    extra = sorted(set(restored) - set(template))
    if missing or extra:
        raise ValueError(f"{model_id} checkpoint lacks {missing[:3]} and has unexpected {extra[:3]}")
    for name, t in template.items():
        if tuple(t.shape) != tuple(restored[name].shape):
            raise ValueError(
                f"{model_id} checkpoint parameter {name} has shape {tuple(restored[name].shape)}, "
                f"model expects {tuple(t.shape)}"
            )


def load_params(
    model_id: str,
    init_fn: Callable[[int], dict[str, torch.Tensor]],
    *,
    seed: int = 0,
    require: bool = False,
) -> dict[str, Any]:
    """The staged weights of ``model_id`` as a ``state_dict`` when a
    checkpoint is present, else ``init_fn(seed)`` (the seeded init) with a
    warning.

    ``init_fn`` returns the model's own ``state_dict``, the template every
    checkpoint parameter's name and shape is checked against. A checkpoint
    that does not match raises when ``require`` is set and otherwise falls
    back to the seeded init with an error logged; ``require=True`` also
    raises when no checkpoint exists."""
    ckpt = find_checkpoint(model_id)
    if ckpt is not None:
        logger.info("loading %s weights from %s", model_id, ckpt)
        template = init_fn(seed)
        try:
            from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict

            restored = flax_to_state_dict(read_flax_msgpack(ckpt.read_bytes()))
            _assert_shapes_match(template, restored, model_id)
            return restored
        except (ValueError, KeyError, TypeError) as e:
            if require:
                raise RuntimeError(f"staged weights at {ckpt} do not match {model_id}'s architecture: {e}") from e
            logger.error(
                "staged weights at %s do not match %s's architecture (%s); falling back to random init",
                ckpt, model_id, e,
            )
            return template
    if require:
        raise RuntimeError(f"no staged weights for {model_id} under {local_dir_for(model_id) / 'params.msgpack'}")
    logger.warning(
        "no staged weights for %s under %s: using seeded random init (stage a params.msgpack there for real inference)",
        model_id, local_dir_for(model_id) / "params.msgpack",
    )
    return init_fn(seed)


def load_module(
    module: torch.nn.Module,
    model_id: str,
    params: dict[str, torch.Tensor] | None = None,
    *,
    require: bool = False,
) -> None:
    """Fill ``module`` with ``params`` (its ``state_dict``) when given, else
    with ``load_params(model_id)``: the staged checkpoint, or the module's
    own seeded init (``module.init_weights(generator)``)."""
    if params is None:
        import torch

        def init(s: int) -> dict[str, torch.Tensor]:
            gen = torch.Generator(device=next(module.parameters()).device)
            gen.manual_seed(s)
            module.init_weights(gen)
            return module.state_dict()

        params = load_params(model_id, init, require=require)
    module.load_state_dict(params, strict=True)
