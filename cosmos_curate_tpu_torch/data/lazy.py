"""LazyData: a container for large payloads that defers materialization
(port of ``cosmos_curate_tpu/data/lazy.py``).

A payload is

- **inline**: held in memory, travelling with its task through the object
  store as a zero-copy pickle (PEP 574 out-of-band buffers);
- **stored**: spilled to a storage path; only the path pickles, and the
  consumer loads it on first access;
- **absent**: consumed or cleared to free memory.

Host data only (bytes, numpy): the object store and stage save pickle it.
"""

from __future__ import annotations

import pickle
from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class LazyData(Generic[T]):
    """Holds ``bytes | numpy``-like payloads lazily.

    Not thread-safe; tasks are owned by one worker at a time by design.
    """

    __slots__ = ("_value", "_path", "_loader")

    def __init__(
        self,
        value: T | None = None,
        *,
        path: str | None = None,
        loader: Callable[[str], T] | None = None,
    ) -> None:
        if value is None and path is None:
            raise ValueError("LazyData needs an inline value or a stored path")
        self._value = value
        self._path = path
        self._loader = loader

    # -- state ------------------------------------------------------------
    @property
    def is_inline(self) -> bool:
        return self._value is not None

    @property
    def is_stored(self) -> bool:
        return self._path is not None

    @property
    def path(self) -> str | None:
        return self._path

    # -- access -----------------------------------------------------------
    def get(self) -> T:
        """Materialize: returns the inline value or loads from storage."""
        if self._value is not None:
            return self._value
        if self._path is None:
            raise RuntimeError("LazyData already cleared")
        loader = self._loader or _default_loader
        self._value = loader(self._path)
        return self._value

    def store(self, path: str, writer: Callable[[str, T], None] | None = None) -> None:
        """Spill the inline value to ``path`` and drop it from memory.

        Non-bytes values use pickle by default and therefore require a
        ``.pkl`` path so the default loader round-trips them."""
        if self._value is None:
            raise RuntimeError("nothing inline to store")
        if (
            writer is None
            and self._loader is None
            and not isinstance(self._value, (bytes, bytearray, memoryview))
            and not path.endswith(".pkl")
        ):
            raise ValueError(
                f"default spill of a {type(self._value).__name__} uses pickle; "
                f"use a '.pkl' path or pass an explicit writer+loader ({path!r})"
            )
        (writer or _default_writer)(path, self._value)
        self._path = path
        self._value = None

    def clear(self) -> None:
        """Drop the in-memory copy (keeps the stored path, if any)."""
        self._value = None

    def nbytes(self) -> int:
        v = self._value
        if v is None:
            return 0
        if isinstance(v, (bytes, bytearray, memoryview)):
            return len(v)
        return getattr(v, "nbytes", 0)

    # -- pickle: stored form travels as just the path (+loader) ------------
    # Custom loaders must be picklable (module-level functions, not lambdas).
    def __reduce__(self):
        return (_rebuild, (self._value, self._path, self._loader))

    def __repr__(self) -> str:
        state = "inline" if self.is_inline else ("stored" if self.is_stored else "cleared")
        return f"LazyData<{state}, {self.nbytes()}B, path={self._path!r}>"


def _rebuild(value, path, loader):
    return LazyData(value=value, path=path, loader=loader)


def _default_loader(path: str):
    from cosmos_curate_tpu_torch.storage.client import read_bytes

    data = read_bytes(path)
    if path.endswith(".pkl"):
        return pickle.loads(data)
    return data


def _default_writer(path: str, value) -> None:
    from cosmos_curate_tpu_torch.storage.client import write_bytes

    if isinstance(value, (bytes, bytearray, memoryview)):
        write_bytes(path, bytes(value))
    else:
        write_bytes(path, pickle.dumps(value, protocol=5))
