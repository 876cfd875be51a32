"""Tokenizers for the caption engine (mirror of the byte and BPE tokenizers
in ``cosmos_curate_tpu/models/tokenizer.py``).

The engine only calls ``encode``/``decode``/``decode_bytes``/``eos_id``/
``pad_id``/``vocab_size``:

- ``ByteTokenizer``: ids 0-255 = raw bytes + special tokens, no assets.
- ``BPETokenizer``: self-contained byte-level BPE; loads the same committed
  ``weights/caption-tokenizer/bpe.json`` the JAX package serves with.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

# staging directory for model assets, shared with the JAX package's registry
WEIGHTS_DIR_ENV = "CURATE_MODEL_WEIGHTS_DIR"
# assets committed with the repository
REPO_WEIGHTS_DIR = Path(__file__).resolve().parent.parent.parent / "weights"


class ByteTokenizer:
    PAD = 256
    BOS = 257
    EOS = 258
    IMAGE = 259  # placeholder id marking where vision tokens splice in

    vocab_size = 512

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] if add_bos else []) + ids

    def decode_bytes(self, ids: list[int]) -> bytes:
        return bytes(i for i in ids if i < 256)

    def decode(self, ids: list[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    @property
    def eos_id(self) -> int:
        return self.EOS

    @property
    def pad_id(self) -> int:
        return self.PAD


# Simplified GPT-2-style pretokenizer: contractions, letter runs, digit
# runs, other-symbol runs, whitespace runs (kept with the following word).
_PRETOKEN_RE = re.compile(
    r"'(?:[sdmt]|ll|ve|re)| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+"
)


class BPETokenizer:
    """Byte-level BPE over the shared special-token layout.

    ids 0-255 are raw bytes (so any input is encodable), specials sit at
    256-259 (same slots as ``ByteTokenizer``), merged tokens start at 260.
    """

    PAD = 256
    BOS = 257
    EOS = 258
    IMAGE = 259
    _FIRST_MERGE = 260

    def __init__(self, merges: list[tuple[int, int]] | None = None, vocab_size: int | None = None):
        self.merges: list[tuple[int, int]] = list(merges or [])
        self._ranks: dict[tuple[int, int], int] = {m: i for i, m in enumerate(self.merges)}
        self._token_bytes: list[bytes] = [bytes([i]) for i in range(256)] + [b""] * 4
        for a, b in self.merges:
            self._token_bytes.append(self._token_bytes[a] + self._token_bytes[b])
        self.vocab_size = vocab_size or max(512, self._FIRST_MERGE + len(self.merges))

    def _apply_merges(self, ids: list[int]) -> list[int]:
        """Greedy lowest-rank-first merging (standard BPE apply)."""
        if len(ids) < 2:
            return ids
        while True:
            best_rank = None
            best_i = -1
            for i in range(len(ids) - 1):
                r = self._ranks.get((ids[i], ids[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                return ids
            ids = ids[:best_i] + [self._FIRST_MERGE + best_rank] + ids[best_i + 2 :]

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]:
        out = [self.BOS] if add_bos else []
        for piece in _PRETOKEN_RE.findall(text):
            out.extend(self._apply_merges(list(piece.encode("utf-8"))))
        return out

    def decode_bytes(self, ids: list[int]) -> bytes:
        specials = (self.PAD, self.BOS, self.EOS, self.IMAGE)
        return b"".join(
            self._token_bytes[i] for i in ids if i < len(self._token_bytes) and i not in specials
        )

    def decode(self, ids: list[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    @property
    def eos_id(self) -> int:
        return self.EOS

    @property
    def pad_id(self) -> int:
        return self.PAD

    @classmethod
    def load(cls, path: str | Path) -> "BPETokenizer":
        data = json.loads(Path(path).read_text())
        return cls([tuple(m) for m in data["merges"]], vocab_size=data["vocab_size"])


def default_caption_tokenizer():
    """The caption tokenizer: a staged or committed trained BPE when present
    (word-level tokens, ~3-4x fewer decode steps), else the byte tokenizer.
    Both share the special-token layout, so the vocab-512 configs serve
    either."""
    staged = os.environ.get(WEIGHTS_DIR_ENV)
    roots = ([Path(staged)] if staged else []) + [REPO_WEIGHTS_DIR]
    for root in roots:
        p = root / "caption-tokenizer" / "bpe.json"
        if p.exists():
            return BPETokenizer.load(p)
    return ByteTokenizer()
