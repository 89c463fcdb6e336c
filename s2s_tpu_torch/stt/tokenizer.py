"""Decode-side tokenizers for ASR output.

Whisper/Parakeet checkpoints ship GPT2-style byte-level BPE vocabularies;
transcription only needs **decode** (ids -> text), which is a table lookup
plus the GPT2 byte-decoder.  Vocabs load from a local ``vocab.json`` /
``tokenizer.json`` (no hub access at runtime).
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path


@lru_cache(maxsize=1)
def _gpt2_byte_decoder() -> dict[str, int]:
    """Inverse of GPT2's bytes_to_unicode table."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


class ByteLevelTokenizer:
    """Decode-only byte-level BPE tokenizer."""

    def __init__(self, vocab: dict[str, int], special_ids: set[int] | None = None) -> None:
        self.id_to_token: dict[int, str] = {i: t for t, i in vocab.items()}
        self.special_ids = special_ids or set()
        self._byte_dec = _gpt2_byte_decoder()

    def decode(self, ids, skip_special: bool = True) -> str:
        parts = []
        for i in ids:
            i = int(i)
            if skip_special and i in self.special_ids:
                continue
            tok = self.id_to_token.get(i)
            if tok is None:
                continue
            if tok.startswith("<|") and tok.endswith("|>"):
                if not skip_special:
                    parts.append(tok)
                continue
            parts.append(tok)
        text = "".join(parts)
        try:
            data = bytes(self._byte_dec.get(ch, ord(ch) % 256) for ch in text)
            return data.decode("utf-8", errors="replace")
        except Exception:
            return text

    @classmethod
    def from_file(cls, path: str | Path) -> "ByteLevelTokenizer":
        raw = json.loads(Path(path).read_text())
        if "model" in raw and "vocab" in raw.get("model", {}):  # tokenizer.json
            vocab = raw["model"]["vocab"]
            special = {
                t["id"] for t in raw.get("added_tokens", []) if t.get("special")
            }
        else:  # vocab.json
            vocab, special = raw, set()
        return cls(vocab, special)


class SentencePieceTokenizer:
    """Decode-only SentencePiece-style tokenizer (Parakeet/NeMo BPE vocabs:
    pieces use the ``▁`` word-boundary marker; decode = concat + replace)."""

    def __init__(self, pieces: list[str]) -> None:
        self.pieces = pieces

    def decode(self, ids, skip_special: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if 0 <= i < len(self.pieces):
                piece = self.pieces[i]
                if skip_special and piece.startswith("<") and piece.endswith(">"):
                    continue
                out.append(piece)
        return "".join(out).replace("▁", " ").strip()

    def encode(self, text: str) -> list[int]:
        """Greedy longest-prefix-match encode over the piece vocabulary
        (the ``▁`` word-boundary convention).  NOTE: real SentencePiece is a
        unigram-LM segmentation — greedy matching is a deterministic
        approximation that differs on ambiguous splits; exact parity needs
        the upstream ``.model`` scores.  Used by TTS front-ends where a
        converted vocab.txt is all that ships."""
        if not hasattr(self, "_piece_ids"):
            self._piece_ids = {p: i for i, p in enumerate(self.pieces)}
            self._max_len = max((len(p) for p in self.pieces), default=1)
        ids: list[int] = []
        norm = "▁" + text.strip().replace(" ", "▁")
        pos = 0
        while pos < len(norm):
            for length in range(min(self._max_len, len(norm) - pos), 0, -1):
                piece = norm[pos : pos + length]
                idx = self._piece_ids.get(piece)
                if idx is not None:
                    ids.append(idx)
                    pos += length
                    break
            else:
                pos += 1  # unknown char: skip (no <unk> guarantee in vocab.txt)
        return ids

    @classmethod
    def from_file(cls, path: str | Path) -> "SentencePieceTokenizer":
        """Load from a NeMo ``vocab.txt`` (one piece per line, id = line
        number) or a JSON list / ``{"piece": id}`` map."""
        p = Path(path)
        text = p.read_text(encoding="utf-8")
        if p.suffix == ".json":
            raw = json.loads(text)
            if isinstance(raw, list):
                return cls(raw)
            pieces = [""] * (max(raw.values()) + 1)
            for piece, idx in raw.items():
                pieces[idx] = piece
            return cls(pieces)
        return cls(text.splitlines())


# Whisper language codes in language-token order (<|en|> = 50259, ...).
WHISPER_LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro da hu ta no th "
    "ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn et mk br eu is hy ne mn bs kk sq sw gl mr "
    "pa si km sn yo so af oc ka be tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt "
    "haw ln ha ba jw su yue"
).split()


def whisper_language_code(token_id: int, lang_base: int = 50259) -> str | None:
    idx = token_id - lang_base
    if 0 <= idx < len(WHISPER_LANGUAGES):
        return WHISPER_LANGUAGES[idx]
    return None


def whisper_language_token(code: str, lang_base: int = 50259) -> int | None:
    try:
        return lang_base + WHISPER_LANGUAGES.index(code)
    except ValueError:
        return None
