"""Tokenizers for the caption engine (mirror of the byte and BPE tokenizers
in ``cosmos_curate_tpu/models/tokenizer.py``).

The engine only calls ``encode``/``decode``/``decode_bytes``/``eos_id``/
``pad_id``/``vocab_size``:

- ``ByteTokenizer``: ids 0-255 = raw bytes + special tokens, no assets.
- ``BPETokenizer``: self-contained byte-level BPE; loads the same committed
  ``weights/caption-tokenizer/bpe.json`` the JAX package serves with.
- ``HFVocabTokenizer``: a converted checkpoint's own GPT-2-format
  ``vocab.json`` + ``merges.txt`` with the checkpoint's EXACT token ids and
  Qwen2's pre-tokenizer split (needs the ``regex`` module, imported when
  one is built; there is no fallback to ``re``).
- ``HFJsonTokenizer``: any checkpoint's ``tokenizer.json`` through the
  ``tokenizers`` library (imported when one is built); ``t5_tokenizer``
  serves T5 with it when the checkpoint ships one, else the byte tokenizer.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
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


# GPT-2's printable-unicode byte encoding: every byte maps to a visible
# character, so vocab / merges files stay text
def _gpt2_byte_encoder() -> dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


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


def _parse_gpt2_files(vocab_json: str | Path, merges_txt: str | Path):
    """A GPT-2-format tokenizer's files as (vocab: bytes -> id, merge byte
    pairs in file order)."""
    decoder = {v: k for k, v in _gpt2_byte_encoder().items()}

    def to_bytes(token: str) -> bytes:
        return bytes(decoder[ch] for ch in token)

    raw = json.loads(Path(vocab_json).read_text())
    vocab = {to_bytes(tok): tid for tok, tid in raw.items()}
    pairs: list[tuple[bytes, bytes]] = []
    for line in Path(merges_txt).read_text().splitlines():
        if not line or line.startswith("#version"):
            continue
        left, _, right = line.partition(" ")
        pairs.append((to_bytes(left), to_bytes(right)))
    return vocab, pairs


# Qwen2 / Qwen2.5(-VL) special-token ids (tokenizer_config.json)
QWEN2_SPECIAL_TOKENS = {
    "<|endoftext|>": 151643,
    "<|im_start|>": 151644,
    "<|im_end|>": 151645,
    "<|vision_start|>": 151652,
    "<|vision_end|>": 151653,
    "<|vision_pad|>": 151654,
    "<|image_pad|>": 151655,
    "<|video_pad|>": 151656,
}


class HFVocabTokenizer:
    """GPT-2-format byte-level BPE that keeps the checkpoint's EXACT token
    ids (a converted checkpoint's embedding rows are indexed by them), with
    HF's merge ranks, Qwen2's pre-tokenizer split and the checkpoint's
    special tokens. ``eos_id`` is ``<|im_end|>`` by default, where a chat
    turn ends."""

    # Qwen2 / Qwen2.5 pre-tokenizer split (tokenizer.json's pretokenizer)
    _PRETOK = (
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
        r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    )

    def __init__(
        self,
        vocab: dict[bytes, int],
        merge_ranks: dict[tuple[bytes, bytes], int],
        *,
        specials: dict[str, int] | None = None,
        eos_token: str = "<|im_end|>",
        pad_token: str = "<|endoftext|>",
    ) -> None:
        import regex  # \p{L} / \p{N} classes: the standard re module has none

        self._vocab = vocab
        self._ranks = merge_ranks
        self._id_to_bytes = {i: b for b, i in vocab.items()}
        self.specials = dict(specials or {})
        for sid in self.specials.values():
            self._id_to_bytes.setdefault(sid, b"")  # specials decode to ''
        self._eos = self.specials.get(eos_token)
        self._pad = self.specials.get(pad_token)
        if self._eos is None or self._pad is None:
            raise ValueError(f"specials must define {eos_token!r} and {pad_token!r}")
        self._splitter = regex.compile(self._PRETOK)
        self.vocab_size = max(max(vocab.values()), *self.specials.values(), 0) + 1

    @classmethod
    def from_gpt2_files(
        cls,
        vocab_json: str | Path,
        merges_txt: str | Path,
        *,
        specials: dict[str, int] | None = None,
        **kw,
    ) -> "HFVocabTokenizer":
        vocab, pairs = _parse_gpt2_files(vocab_json, merges_txt)
        ranks = {pair: rank for rank, pair in enumerate(pairs)}
        return cls(vocab, ranks, specials=QWEN2_SPECIAL_TOKENS if specials is None else specials, **kw)

    def _bpe(self, chunk: bytes) -> list[int]:
        parts = [bytes([b]) for b in chunk]
        while len(parts) > 1:
            best, best_rank = -1, None
            for i in range(len(parts) - 1):
                r = self._ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best_rank is None:
                break
            parts[best : best + 2] = [parts[best] + parts[best + 1]]
        out = []
        for p in parts:
            tid = self._vocab.get(p)
            if tid is None:  # a byte outside a byte-level vocab (defensive)
                out.extend(self._vocab.get(bytes([b]), 0) for b in p)
            else:
                out.append(tid)
        return out

    def encode(self, text: str, *, add_bos: bool = False) -> list[int]:  # noqa: ARG002
        # HF's Qwen2 tokenizer NFC-normalizes before pre-tokenization
        text = unicodedata.normalize("NFC", text)
        ids: list[int] = []
        for piece in self._splitter.findall(text):
            ids.extend(self._bpe(piece.encode("utf-8")))
        return ids

    def decode_bytes(self, ids: list[int]) -> bytes:
        return b"".join(self._id_to_bytes.get(i, b"") for i in ids)

    def decode(self, ids: list[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    @property
    def eos_id(self) -> int:
        return self._eos

    @property
    def pad_id(self) -> int:
        return self._pad


class HFJsonTokenizer:
    """A checkpoint's EXACT tokenization from its ``tokenizer.json``, through
    the ``tokenizers`` library (imported here, when one is built). Satisfies
    the engine's tokenizer protocol."""

    def __init__(
        self,
        path: str | Path,
        *,
        eos_token: str = "</s>",
        pad_token: str = "<pad>",
        add_special_tokens: bool = True,
    ) -> None:
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(str(path))
        self._add_special = add_special_tokens
        eos = self._tok.token_to_id(eos_token)
        pad = self._tok.token_to_id(pad_token)
        if eos is None or pad is None:
            raise ValueError(f"tokenizer at {path} lacks {eos_token!r}/{pad_token!r}")
        self._eos = eos
        self._pad = pad
        # max id + 1, not the token count: sparse added-token ids above the
        # count would pass T5's vocab guard and then index past the table
        vocab = self._tok.get_vocab(with_added_tokens=True)
        self.vocab_size = (max(vocab.values()) + 1) if vocab else 0

    def encode(self, text: str, *, add_bos: bool = False) -> list[int]:  # noqa: ARG002
        return self._tok.encode(text, add_special_tokens=self._add_special).ids

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def decode_bytes(self, ids: list[int]) -> bytes:
        return self.decode(ids).encode("utf-8")

    @property
    def eos_id(self) -> int:
        return self._eos

    @property
    def pad_id(self) -> int:
        return self._pad


def t5_tokenizer(model_id: str = "t5-encoder-tpu"):
    """The T5 tokenizer: the checkpoint's staged or committed
    ``tokenizer.json`` when present (the embedding rows are indexed by its
    ids), else the byte tokenizer, which only a seeded init may serve."""
    from cosmos_curate_tpu_torch.models.registry import find_model_file

    p = find_model_file(model_id, "tokenizer.json")
    if p is not None:
        return HFJsonTokenizer(p)
    return ByteTokenizer()
