"""Self-contained sentence segmentation for streamed LLM text.

The reference uses ``nltk.sent_tokenize`` (with a punkt_tab download at
startup, reference ``s2s_pipeline.py:54-62``).  This build has no model
download step, so segmentation is a deterministic rule-based splitter tuned
for the TTS batching use case: terminal punctuation (. ! ? … and CJK 。！？)
followed by whitespace/end, with protection for common abbreviations,
initials, decimals, and ellipses.
"""

from __future__ import annotations

import re

_ABBREVIATIONS = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "inc", "ltd", "co",
    "e.g", "i.e", "cf", "al", "approx", "dept", "est", "fig", "gen", "gov", "hon",
    "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep", "sept", "oct", "nov", "dec",
    "no", "vol", "rev", "univ", "assn", "capt", "col", "sgt", "lt", "cmdr", "mt",
}

# Candidate boundary: terminal punct (+ closing quotes/brackets) then spaces,
# or CJK terminal punct (no space required).
_BOUNDARY = re.compile(
    r"([.!?…]+[\"'»)\]]*)(\s+)|([。！？][”』」)]*)()"
)


def _is_abbreviation(text_before: str) -> bool:
    m = re.search(r"(\w[\w.]*)$", text_before)
    if not m:
        return False
    word = m.group(1).rstrip(".").lower()
    if word in _ABBREVIATIONS:
        return True
    # single-letter initial, e.g. "J." in "J. Smith"
    if len(word) == 1 and word.isalpha():
        return True
    # dotted acronym like "u.s"
    if "." in word and all(len(p) <= 1 or p in _ABBREVIATIONS for p in word.split(".")):
        return True
    return False


def split_complete(text: str) -> tuple[list[str], str]:
    """Split *text* into (complete sentences, verbatim remainder).

    The remainder preserves the original trailing characters (including
    whitespace) so streamed text can keep accumulating onto it without losing
    separators between pieces.
    """
    if not text:
        return [], ""
    sentences: list[str] = []
    start = 0
    for m in _BOUNDARY.finditer(text):
        end = m.end(1) if m.group(1) is not None else m.end(3)
        if m.group(1) is not None and _is_abbreviation(text[start : m.start(1)]):
            # decimals like "3.14" never match (no space after the dot);
            # abbreviations like "Dr." are skipped here
            continue
        candidate = text[start:end].strip()
        if candidate:
            sentences.append(candidate)
        start = m.end()
    return sentences, text[start:]


def split_sentences(text: str) -> list[str]:
    """Split *text* into sentences. The trailing fragment (no terminal punct)
    is returned as the final element."""
    sentences, tail = split_complete(text)
    tail = tail.strip()
    if tail:
        sentences.append(tail)
    return sentences
