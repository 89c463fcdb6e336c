"""Text-based language identification (reference uses the ``lingua`` package
for Parakeet's language reporting, ``parakeet_tdt_handler.py:72-88``).

Self-contained two-stage heuristic: script ranges decide CJK/Cyrillic/etc.
outright; Latin-script text is scored by stopword hits across the languages
the bundled STT backends report.  Good enough for the reply-language prompt;
a converter can swap in a real classifier later.
"""

from __future__ import annotations

import re

_SCRIPT_RANGES = (
    ("zh", re.compile(r"[一-鿿]")),
    ("ja", re.compile(r"[぀-ヿ]")),
    ("ko", re.compile(r"[가-힯]")),
    ("ru", re.compile(r"[Ѐ-ӿ]")),
    ("hi", re.compile(r"[ऀ-ॿ]")),
)

_STOPWORDS: dict[str, frozenset[str]] = {
    "en": frozenset("the and you are was for with this that have what is it of to in on".split()),
    "de": frozenset("der die das und ich nicht ist ein eine mit für auf sie wir".split()),
    "fr": frozenset("le la les et je ne pas est une des que vous nous c'est".split()),
    "es": frozenset("el la los las y no es una que de por para con usted".split()),
    "it": frozenset("il la le e non è una che di per con questo sono".split()),
    "pt": frozenset("o a os as e não é uma que de para com você está".split()),
    "nl": frozenset("de het een en niet is van dat je ik voor met zijn".split()),
    "pl": frozenset("i nie to jest się na w z że do tak jak ale".split()),
    "sv": frozenset("och att det som en är jag på för inte med har av".split()),
    "fi": frozenset("ja ei se on että en minä mutta kun niin ole mitä".split()),
}


def detect_language(text: str, default: str | None = "en") -> str | None:
    """Best-effort language code for *text* (None when too short to judge)."""
    if not text or len(text.strip()) < 2:
        return None
    for code, pattern in _SCRIPT_RANGES:
        if pattern.search(text):
            return code
    words = re.findall(r"[\w']+", text.lower())
    if not words:
        return default
    best, best_hits = default, 0
    for code, stops in _STOPWORDS.items():
        hits = sum(1 for w in words if w in stops)
        if hits > best_hits:
            best, best_hits = code, hits
    return best
