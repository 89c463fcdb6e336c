"""A synthetic tokenizer for the local LM, in ``tokenizer.json`` form.

SmolLM2's own tokenizer is not in the repository and there is no network.
Without one the port's LM decodes its ids through the byte fallback (each
id modulo 256 is a byte), and random weights then fall into a loop on one
id whose byte is unspeakable about two times in three: the reply has no
audio.  This tokenizer keeps the model's 49,152 ids and gives every id a
speakable piece, as a real BPE vocabulary mostly does: ids 0-2 are the
special tokens (``<|endoftext|>``, ``<|im_start|>``, ``<|im_end|>``, the
LM's end of reply), ids 3-258 the 256 bytes (so any prompt encodes, a
byte a token, and no merges), and every later id a word of two or three
syllables after a space.  The file is made from a fixed list, not from
the run's seed, and written once into the checkout's build directory.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path

SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
CONSONANTS = "bdfgklmnprstvz"
VOWELS = "aeiou"


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte-level alphabet: each byte as a printable character."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def words(n: int) -> list[str]:
    """*n* distinct words of two, then three, consonant-vowel syllables."""
    syllables = [c + v for c in CONSONANTS for v in VOWELS]
    out: list[str] = []
    for k in (2, 3):
        for parts in itertools.product(syllables, repeat=k):
            out.append("".join(parts))
            if len(out) == n:
                return out
    raise ValueError(f"cannot make {n} words")


def tokenizer_json(vocab_size: int) -> dict:
    byte_chars = _bytes_to_unicode()
    vocab = {tok: i for i, tok in enumerate(SPECIALS)}
    for b in range(256):
        vocab[byte_chars[b]] = len(vocab)
    space = byte_chars[ord(" ")]
    for w in words(vocab_size - len(vocab)):
        vocab[space + w] = len(vocab)
    return {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [{"id": i, "content": tok, "single_word": False, "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True} for i, tok in enumerate(SPECIALS)],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                          "use_regex": True},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab, "merges": []},
    }


def path(root: Path, vocab_size: int) -> Path:
    """The tokenizer file of *vocab_size* ids under *root*'s build
    directory, written there the first time."""
    out = root / "build" / "s2sbench" / "tokenizer" / f"synthetic-{vocab_size}.json"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        tmp.write_text(json.dumps(tokenizer_json(vocab_size)))
        tmp.replace(out)
    return out
