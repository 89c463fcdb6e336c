"""LLM text utilities (reference ``LLM/utils.py``)."""

from __future__ import annotations

import base64
import io
import re
from typing import Optional

SMART_PUNCT = str.maketrans({"‘": "'", "’": "'", "“": '"', "”": '"'})

_SPEECHABLE = re.compile(
    r"[^\w\s.,!?;:'\"\-()\/\\@#%&*+=$€£¥₹₽¢\[\]{}<>~`^|…—–，。！？；：、\n\r\t]",
    flags=re.UNICODE,
)


def remove_unspeechable(text: str) -> str:
    """Keep letters/digits/punct/whitespace across scripts (incl. CJK punct);
    drop emoji and symbols TTS can't speak."""
    return _SPEECHABLE.sub("", text.translate(SMART_PUNCT))


def first_tts_chunk_text(pieces, n_sentences: int) -> str | None:
    """The text of the FIRST sentence-batched TTS chunk the LLM stream loop
    (``base_handler._stream`` + ``_drain_printable``) would emit for this
    decoded-piece stream on an audio-wanting turn — used by whole-chain
    speculation to pre-synthesize it.  Returns None when the stream ends
    before any speakable text forms.  Mismatches are safe (the real input
    simply doesn't adopt), so the tool-block path is not replicated —
    speculation is skipped for tool sessions upstream."""
    from s2s_tpu_torch.utils.sentences import split_complete

    batch: list[str] = []
    printable = ""
    for piece in pieces:
        printable += remove_unspeechable(piece)
        complete, printable = split_complete(printable)
        for sentence in complete:
            batch.append(sentence)
            if len(batch) >= n_sentences:
                return " ".join(batch)
    # stream ended early: the loop's tail flush joins what accumulated
    if printable.strip():
        batch.append(printable.strip())
    return " ".join(batch) if batch else None


#: STT language code -> lowercase language name for the reply-language prompt.
#: Must cover every language any bundled STT backend can report (CI-checked).
STT_LANGUAGE_NAMES = {
    "en": "english", "fr": "french", "es": "spanish", "zh": "chinese", "ja": "japanese",
    "ko": "korean", "hi": "hindi", "de": "german", "pt": "portuguese", "pl": "polish",
    "it": "italian", "nl": "dutch", "ru": "russian", "uk": "ukrainian", "cs": "czech",
    "sk": "slovak", "hu": "hungarian", "ro": "romanian", "bg": "bulgarian", "hr": "croatian",
    "sl": "slovenian", "sr": "serbian", "da": "danish", "no": "norwegian", "sv": "swedish",
    "fi": "finnish", "et": "estonian", "lv": "latvian", "lt": "lithuanian",
}


def resolve_auto_language(language_code: Optional[str]) -> tuple[Optional[str], Optional[str]]:
    """Strip a ``-auto`` suffix; return ``(clean_code, language_name)``."""
    if not language_code:
        return language_code, None
    if language_code.endswith("-auto"):
        language_code = language_code[:-5]
    return language_code, STT_LANGUAGE_NAMES.get(language_code)


def image_url_to_pil(image_url: str):
    """Decode a data URI (or fetch an http URL) into a PIL image.
    PIL is an optional dependency; raises ImportError when absent."""
    from PIL import Image  # noqa: PLC0415

    if image_url.startswith("data:"):
        _, b64 = image_url.split(",", 1)
        return Image.open(io.BytesIO(base64.b64decode(b64)))
    import httpx

    resp = httpx.get(image_url, timeout=10)
    resp.raise_for_status()
    return Image.open(io.BytesIO(resp.content))
