"""Grapheme-to-phoneme front-ends for Kokoro (reference
``TTS/kokoro_handler.py:214-249``, whose ``KPipeline`` runs the ``misaki``
G2P — espeak-ng backed for non-English — before the phoneme->id map).

Two engines behind one ``phonemize(text) -> str`` seam:

- :class:`EspeakPhonemizer` — the ``phonemizer`` package (espeak-ng
  backend) when importable: full language coverage, highest quality.
- :class:`EnglishG2P` — dependency-free American-English fallback:
  a ~200-word exception lexicon plus ordered letter-to-sound rules,
  emitting IPA restricted to Kokoro's symbol inventory.  Heuristic by
  design (rule-based G2P is never perfect) but deterministic, and every
  emitted symbol is guaranteed to resolve through a real checkpoint's
  phoneme vocab, so converted Kokoro weights can speak from plain text.

:func:`resolve_phonemizer` picks the best available engine; the raw
phoneme-string path stays open for tests and power users
(``--tts_phoneme_input``).
"""

from __future__ import annotations

import re
from typing import Callable, Optional

#: Every symbol :class:`EnglishG2P` may emit (subset of the Kokoro-82M /
#: StyleTTS2 phoneme inventory; stress marks + IPA + pass-through
#: punctuation).  Tests assert emission ⊆ this set.
G2P_SYMBOLS = set("ˈˌːɑæʌɔəɚɛɜɪʊŋɹʃʒðθɡʤʧabdefhijklmnopstuvwz ,.!?;:—…\"'")

# ---------------------------------------------------------------------------
# exception lexicon — words English spelling rules get wrong
# ---------------------------------------------------------------------------

LEXICON: dict[str, str] = {
    # articles / pronouns / function words (unstressed, ð- forms)
    "a": "ə", "an": "ən", "the": "ðə", "of": "əv", "to": "tu", "and": "ænd",
    "in": "ɪn", "is": "ɪz", "it": "ɪt", "you": "ju", "that": "ðæt",
    "he": "hi", "she": "ʃi", "we": "wi", "they": "ðeɪ", "i": "ˈaɪ",
    "was": "wʌz", "for": "fɔɹ", "on": "ɑn", "are": "ɑɹ", "as": "æz",
    "with": "wɪð", "his": "hɪz", "her": "hɚ", "be": "bi", "at": "æt",
    "by": "baɪ", "this": "ðɪs", "had": "hæd", "have": "hæv", "has": "hæz",
    "from": "fɹʌm", "or": "ɔɹ", "but": "bʌt", "not": "nɑt", "what": "wʌt",
    "all": "ɔl", "were": "wɚ", "when": "wɛn", "your": "jɔɹ", "can": "kæn",
    "said": "sɛd", "there": "ðɛɹ", "use": "juz", "each": "iʧ",
    "which": "wɪʧ", "do": "du", "how": "haʊ", "their": "ðɛɹ", "if": "ɪf",
    "will": "wɪl", "other": "ˈʌðɚ", "about": "əˈbaʊt", "out": "aʊt",
    "many": "ˈmɛni", "then": "ðɛn", "them": "ðɛm", "these": "ðiz",
    "so": "soʊ", "some": "sʌm", "would": "wʊd", "into": "ˈɪntu",
    "more": "mɔɹ", "two": "tu", "could": "kʊd", "who": "hu", "been": "bɪn",
    "now": "naʊ", "did": "dɪd", "down": "daʊn", "only": "ˈoʊnli",
    "my": "maɪ", "than": "ðæn", "first": "fɚst", "very": "ˈvɛɹi",
    "after": "ˈæftɚ", "our": "ˈaʊɚ", "just": "ʤʌst", "me": "mi",
    "most": "moʊst", "know": "noʊ", "get": "ɡɛt", "through": "θɹu",
    "any": "ˈɛni", "where": "wɛɹ", "much": "mʌʧ", "before": "bɪˈfɔɹ",
    "too": "tu", "also": "ˈɔlsoʊ", "does": "dʌz", "here": "hiɹ",
    "why": "waɪ", "again": "əˈɡɛn", "off": "ɔf", "went": "wɛnt",
    "come": "kʌm", "give": "ɡɪv", "live": "lɪv", "because": "bɪˈkʌz",
    "once": "wʌns", "says": "sɛz", "one": "wʌn", "don't": "doʊnt",
    "won't": "woʊnt", "can't": "kænt", "i'm": "ˈaɪm", "it's": "ɪts",
    "something": "ˈsʌmθɪŋ", "nothing": "ˈnʌθɪŋ", "anything": "ˈɛniθɪŋ",
    "people": "ˈpipəl", "water": "ˈwɔtɚ", "over": "ˈoʊvɚ",
    "little": "ˈlɪtəl", "work": "wɚk", "world": "wɚld", "word": "wɚd",
    "should": "ʃʊd", "great": "ɡɹeɪt", "good": "ɡʊd",
    "want": "wɑnt", "say": "seɪ", "new": "nu", "old": "oʊld",
    "day": "deɪ", "way": "weɪ", "may": "meɪ", "year": "jiɹ",
    "years": "jiɹz", "time": "taɪm", "no": "noʊ", "yes": "jɛs",
    "hello": "həˈloʊ", "hi": "haɪ", "okay": "ˌoʊˈkeɪ", "ok": "ˌoʊˈkeɪ",
    "please": "pliz", "thanks": "θæŋks", "thank": "θæŋk",
    "sorry": "ˈsɑɹi", "sure": "ʃʊɹ", "right": "ɹaɪt", "today": "təˈdeɪ",
    "tomorrow": "təˈmɑɹoʊ", "tonight": "təˈnaɪt", "weather": "ˈwɛðɚ",
    "question": "ˈkwɛsʧən", "answer": "ˈænsɚ", "listen": "ˈlɪsən",
    "speech": "spiʧ", "voice": "vɔɪs", "language": "ˈlæŋɡwəʤ",
    "model": "ˈmɑdəl", "computer": "kəmˈpjutɚ", "every": "ˈɛvɹi",
    "eye": "aɪ", "eyes": "aɪz", "heart": "hɑɹt", "earth": "ɜːθ",
    "idea": "aɪˈdiə", "area": "ˈɛɹiə", "usually": "ˈjuʒuəli",
    "business": "ˈbɪznəs", "minute": "ˈmɪnət", "friend": "fɹɛnd",
    "beautiful": "ˈbjutəfəl", "done": "dʌn", "gone": "ɡɔn",
    "love": "lʌv", "move": "muv", "lose": "luz", "whose": "huz",
    "woman": "ˈwʊmən", "women": "ˈwɪmən", 
    "course": "kɔɹs", "half": "hæf", "hour": "ˈaʊɚ", "hours": "ˈaʊɚz",
    "though": "ðoʊ", "thought": "θɔt", "enough": "ɪˈnʌf",
    "laugh": "læf", "tough": "tʌf", "rough": "ɹʌf", "cough": "kɔf",
    "island": "ˈaɪlənd", "often": "ˈɔfən",  "money": "ˈmʌni", "busy": "ˈbɪzi", "pretty": "ˈpɹɪti",
    "early": "ˈɜːli", "learn": "lɜːn", "heard": "hɜːd",
    "iron": "ˈaɪɚn", "sugar": "ˈʃʊɡɚ", "talk": "tɔk", "walk": "wɔk",
    # number words (the normalizer expands digits into these)
    "zero": "ˈziɹoʊ", "oh": "oʊ", "three": "θɹi",
    "four": "fɔɹ", "five": "faɪv", "six": "sɪks", "seven": "ˈsɛvən",
    "eight": "eɪt", "nine": "naɪn", "ten": "tɛn", "eleven": "ɪˈlɛvən",
    "twelve": "twɛlv", "thirteen": "ˌθɚˈtin", "fourteen": "ˌfɔɹˈtin",
    "fifteen": "ˌfɪfˈtin", "sixteen": "ˌsɪksˈtin",
    "seventeen": "ˌsɛvənˈtin", "eighteen": "ˌeɪˈtin",
    "nineteen": "ˌnaɪnˈtin", "twenty": "ˈtwɛnti", "thirty": "ˈθɚti",
    "forty": "ˈfɔɹti", "fifty": "ˈfɪfti", "sixty": "ˈsɪksti",
    "seventy": "ˈsɛvənti", "eighty": "ˈeɪti", "ninety": "ˈnaɪnti",
    "hundred": "ˈhʌndɹəd", "thousand": "ˈθaʊzənd",
    "million": "ˈmɪljən", "billion": "ˈbɪljən", "point": "pɔɪnt",
    "percent": "pɚˈsɛnt", "dollar": "ˈdɑlɚ", "dollars": "ˈdɑlɚz",
}

#: ordered letter-to-sound rules applied left-to-right at each position.
#: Each entry is (regex anchored at the cursor, IPA emission).  First match
#: wins; longest patterns first within a letter family.
_RULES: list[tuple[re.Pattern, str]] = [
    (re.compile(p), ipa)
    for p, ipa in [
        # multi-letter consonant clusters / silent letters
        (r"tch", "ʧ"), (r"ch", "ʧ"), (r"sh", "ʃ"), (r"ph", "f"),
        (r"wh", "w"), (r"ck", "k"), (r"dge", "ʤ"), (r"gh(?=t)", ""),
        (r"kn", "n"), (r"wr", "ɹ"), (r"qu", "kw"), (r"ng\b", "ŋ"),
        (r"ng", "ŋɡ"), (r"nk", "ŋk"), (r"th", "θ"), (r"sch", "sk"),
        (r"gn\b", "n"), (r"mb\b", "m"), (r"x", "ks"),
        # suffix chunks
        (r"tion", "ʃən"), (r"sion", "ʒən"), (r"ture\b", "ʧɚ"),
        (r"cious", "ʃəs"), (r"tious", "ʃəs"), (r"cial", "ʃəl"),
        (r"tial", "ʃəl"), (r"ous\b", "əs"), (r"able\b", "əbəl"),
        (r"ible\b", "əbəl"), (r"ment\b", "mənt"), (r"ness\b", "nəs"),
        (r"ful\b", "fəl"), (r"ing\b", "ɪŋ"), (r"ly\b", "li"),
        (r"age\b", "əʤ"), (r"ize\b", "aɪz"), (r"ise\b", "aɪz"),
        (r"er\b", "ɚ"), (r"ers\b", "ɚz"), (r"or\b", "ɚ"), (r"ar\b", "ɚ"),
        (r"est\b", "əst"), (r"ed\b", "d"),
        # vowel digraphs
        (r"eigh", "eɪ"), (r"igh", "aɪ"), (r"aw", "ɔ"), (r"au", "ɔ"),
        (r"oo", "u"), (r"ee", "i"), (r"ea", "i"), (r"ai", "eɪ"),
        (r"ay\b", "eɪ"), (r"ay", "eɪ"), (r"ey\b", "i"), (r"ei", "eɪ"),
        (r"oa", "oʊ"), (r"ow\b", "oʊ"), (r"ow", "aʊ"), (r"ou", "aʊ"),
        (r"oi", "ɔɪ"), (r"oy", "ɔɪ"), (r"ue\b", "u"), (r"ew", "u"),
        (r"ie\b", "aɪ"), (r"ie", "i"), (r"ui", "u"),
        # r-colored vowels
        (r"er", "ɚ"), (r"ir", "ɚ"), (r"ur", "ɚ"), (r"or", "ɔɹ"),
        (r"ar", "ɑɹ"),
        # magic-e long vowels: V + single consonant + final e
        (r"a(?=[bcdfgklmnprstvz]e\b)", "eɪ"),
        (r"i(?=[bcdfgklmnprstvz]e\b)", "aɪ"),
        (r"o(?=[bcdfgklmnprstvz]e\b)", "oʊ"),
        (r"u(?=[bcdfgklmnprstvz]e\b)", "ju"),
        (r"e(?=[bcdfgklmnprstvz]e\b)", "i"),
        (r"e\b", ""),  # silent final e
        # soft c / g
        (r"c(?=[eiy])", "s"), (r"g(?=[eiy])", "ʤ"),
        # single vowels (short defaults)
        (r"a", "æ"), (r"e", "ɛ"), (r"i", "ɪ"), (r"o", "ɑ"), (r"u", "ʌ"),
        (r"y\b", "i"), (r"y", "ɪ"),
        # single consonants
        (r"b", "b"), (r"c", "k"), (r"d", "d"), (r"f", "f"), (r"g", "ɡ"),
        (r"h", "h"), (r"j", "ʤ"), (r"k", "k"), (r"l", "l"), (r"m", "m"),
        (r"n", "n"), (r"p", "p"), (r"r", "ɹ"), (r"s", "s"), (r"t", "t"),
        (r"v", "v"), (r"w", "w"), (r"z", "z"), (r"'", ""),
    ]
]

_VOWEL_PHONES = set("ɑæʌɔəɚɛɜɪʊiu") | {"eɪ", "aɪ", "oʊ", "aʊ", "ɔɪ"}

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]


def number_to_words(n: int) -> str:
    """Integer -> English words (0 .. 999,999,999,999)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + (" " + _ONES[r] if r else "")
    for unit, name in ((10 ** 9, "billion"), (10 ** 6, "million"),
                       (1000, "thousand"), (100, "hundred")):
        if n >= unit:
            head, r = divmod(n, unit)
            return number_to_words(head) + f" {name}" + (
                " " + number_to_words(r) if r else "")
    return _ONES[0]


def _expand_numbers(text: str) -> str:
    def words_for(s: str) -> str:
        s = s.replace(",", "")
        if "." in s:
            whole, frac = s.split(".", 1)
            return (number_to_words(int(whole or 0)) + " point "
                    + " ".join(_ONES[int(d)] for d in frac if d.isdigit()))
        try:
            return number_to_words(int(s))
        except ValueError:
            return s

    text = re.sub(r"\$\s*(\d[\d,]*(?:\.\d+)?)",
                  lambda m: m.group(1) + " dollars", text)
    text = re.sub(r"(\d[\d,]*(?:\.\d+)?)\s*%",
                  lambda m: m.group(1) + " percent", text)
    return re.sub(r"\d[\d,]*(?:\.\d+)?", lambda m: words_for(m.group(0)), text)


class EnglishG2P:
    """Rule-based American-English G2P emitting Kokoro-compatible IPA.

    Lexicon first, then the ordered letter-to-sound rules; primary stress
    ``ˈ`` is placed on the first vowel of rule-derived words (lexicon
    entries carry their own stress).  Punctuation Kokoro's vocab knows
    passes through so prosody boundaries survive.
    """

    #: punctuation forwarded verbatim (all present in Kokoro's vocab)
    _PUNCT = set(",.!?;:—…\"'")

    def phonemize_word(self, word: str) -> str:
        lex = LEXICON.get(word)
        if lex is not None:
            return lex
        out: list[str] = []
        i = 0
        # anchor rules against the remaining suffix; \b needs the boundary
        while i < len(word):
            for pat, ipa in _RULES:
                m = pat.match(word, i)
                if m and m.end() > i:
                    out.append(ipa)
                    i = m.end()
                    break
            else:
                i += 1  # unknown character: skip
        # place primary stress before the first vowel phone
        phones = "".join(out)
        for j, ch in enumerate(phones):
            if ch in "ɑæʌɔəɚɛɜɪʊiueao":
                return phones[:j] + "ˈ" + phones[j:]
        return phones

    def __call__(self, text: str) -> str:
        text = _expand_numbers(text)
        pieces: list[str] = []
        for tok in re.findall(r"[A-Za-z']+|[^\sA-Za-z']", text):
            if tok[0].isalpha() or tok[0] == "'":
                word = tok.lower()
                if word.endswith("'s") and word not in LEXICON:
                    base = self.phonemize_word(word[:-2])
                    suffix = "s" if base and base[-1] in "pktfθ" else "z"
                    pieces.append(base + suffix)
                else:
                    pieces.append(self.phonemize_word(word))
            elif tok in self._PUNCT:
                if pieces:
                    pieces[-1] = pieces[-1] + tok
                else:
                    pieces.append(tok)
        return " ".join(p for p in pieces if p)


class EspeakPhonemizer:
    """``phonemizer``-package espeak-ng backend (preferred when present;
    mirrors misaki's espeak fallback inside the reference's KPipeline)."""

    def __init__(self, lang: str = "en-us") -> None:
        from phonemizer.backend import EspeakBackend  # raises if unavailable

        self._backend = EspeakBackend(
            lang, preserve_punctuation=True, with_stress=True)

    def __call__(self, text: str) -> str:
        out = self._backend.phonemize([text], strip=True)
        return out[0] if out else ""


def resolve_phonemizer(lang: str = "en-us") -> Optional[Callable[[str], str]]:
    """Best available G2P for ``lang``: espeak-ng when importable, the
    built-in English rules for ``en*`` otherwise, ``None`` (raw phoneme
    pass-through) for other languages without espeak."""
    try:
        return EspeakPhonemizer(lang)
    except Exception:
        pass
    if lang.lower().startswith("en"):
        return EnglishG2P()
    return None
