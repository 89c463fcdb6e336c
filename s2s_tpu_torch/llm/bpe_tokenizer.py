"""Byte-level BPE tokenizer (encode + decode) for the local LLM, loaded
from a local ``tokenizer.json`` — no hub access.

The reference gets tokenization from transformers/mlx
(``LLM/language_model.py:642-672``); here the fast path wraps the
``tokenizers`` runtime when present, with a pure-Python byte-level BPE
implementation (GPT2 pretokenization regex + merge ranks) as a dependency-
free fallback.  Both paths are parity-tested against each other
(``tests/test_llm.py``).
"""

from __future__ import annotations

import json
import re
from functools import lru_cache
from pathlib import Path
from typing import Any

#: GPT2 pre-tokenization pattern: contractions, letter runs, digit runs,
#: punctuation runs, whitespace.  (``[^\W\d_]`` ~ ``\p{L}``.)  The pure
#: fallback targets this classic pattern; checkpoint-specific regex
#: variants are handled by the ``tokenizers`` fast path.
_GPT2_PATTERN = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+",
    re.UNICODE,
)


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


class PurePythonBPE:
    """Byte-level BPE encode/decode from a parsed ``tokenizer.json``."""

    def __init__(self, data: dict[str, Any]) -> None:
        model = data["model"]
        self.vocab: dict[str, int] = model["vocab"]
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        merges = model.get("merges", [])
        self.ranks: dict[tuple[str, str], int] = {}
        for rank, merge in enumerate(merges):
            pair = tuple(merge) if isinstance(merge, list) else tuple(merge.split(" ", 1))
            self.ranks[pair] = rank
        self.added: dict[str, int] = {}
        self.special_ids: set[int] = set()
        for tok in data.get("added_tokens", []):
            self.added[tok["content"]] = tok["id"]
            self.id_to_token[tok["id"]] = tok["content"]
            if tok.get("special"):
                self.special_ids.add(tok["id"])
        self._byte_enc = _bytes_to_unicode()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        self._added_re = (
            re.compile("(" + "|".join(re.escape(t) for t in
                                      sorted(self.added, key=len, reverse=True)) + ")")
            if self.added else None
        )

    def _bpe_word(self, word: str) -> list[str]:
        parts = list(word)
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                rank = self.ranks.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return parts

    def encode(self, text: str) -> list[int]:
        segments = self._added_re.split(text) if self._added_re else [text]
        ids: list[int] = []
        for seg in segments:
            if not seg:
                continue
            if seg in self.added:
                ids.append(self.added[seg])
                continue
            for word in _GPT2_PATTERN.findall(seg):
                mapped = "".join(self._byte_enc[b] for b in word.encode("utf-8"))
                for piece in self._bpe_word(mapped):
                    idx = self.vocab.get(piece)
                    if idx is not None:
                        ids.append(idx)
        return ids

    def decode(self, ids, skip_special: bool = True) -> str:
        out: list[str] = []
        buf: list[str] = []

        def flush():
            if buf:
                data = bytes(self._byte_dec.get(ch, ord(ch) % 256) for ch in "".join(buf))
                out.append(data.decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            i = int(i)
            tok = self.id_to_token.get(i)
            if tok is None:
                continue
            if i in self.special_ids or tok in self.added:
                flush()
                if not skip_special:
                    out.append(tok)
                continue
            buf.append(tok)
        flush()
        return "".join(out)


class BPETokenizer:
    """Local-LLM tokenizer: ``tokenizers`` runtime when available, pure
    Python otherwise.  Exposes ``vocab_size`` / ``eos_id`` / ``encode`` /
    ``decode`` — the seam :mod:`s2s_tpu_torch.llm.local_backend` expects."""

    def __init__(self, path: str | Path, eos_token: str | None = None) -> None:
        raw = json.loads(Path(path).read_text(encoding="utf-8"))
        self._py = PurePythonBPE(raw)
        self._fast = None
        try:
            from tokenizers import Tokenizer

            self._fast = Tokenizer.from_file(str(path))
        except Exception:  # tokenizers missing or json unsupported: pure path
            pass
        specials = {raw_tok["content"]: raw_tok["id"] for raw_tok in raw.get("added_tokens", [])}
        self.eos_id = 0
        for cand in ([eos_token] if eos_token else []) + [
            "<|im_end|>", "<|endoftext|>", "</s>", "<|eot_id|>",
        ]:
            if cand in specials:
                self.eos_id = specials[cand]
                break
        self.vocab_size = max(
            len(self._py.vocab), max(self._py.id_to_token, default=0) + 1
        )

    def encode(self, text: str) -> list[int]:
        if self._fast is not None:
            return self._fast.encode(text, add_special_tokens=False).ids
        return self._py.encode(text)

    def decode(self, ids, skip_special: bool = True) -> str:
        ids = [int(i) for i in ids]
        if self._fast is not None:
            return self._fast.decode(ids, skip_special_tokens=skip_special)
        return self._py.decode(ids, skip_special=skip_special)
