"""Small shared helpers (reference ``utils/utils.py``)."""

from __future__ import annotations

import uuid
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from s2s_tpu_torch.realtime.types import ResponseCreateParams


def response_wants_audio(response: "ResponseCreateParams | None") -> bool:
    """OpenAI ``output_modalities`` semantics: absent/empty or containing
    "audio" => audio; a non-empty list without "audio" => text only."""
    if response is None:
        return True
    mods = response.output_modalities
    return not mods or "audio" in mods


def is_out_of_band(response: "ResponseCreateParams | None") -> bool:
    """``conversation="none"`` responses run against a throwaway context and
    never commit back to the default conversation."""
    return response is not None and response.conversation == "none"


def next_power_of_2(x: int) -> int:
    return 1 if x == 0 else 2 ** (x - 1).bit_length()


def generate_id(prefix: str) -> str:
    return f"{prefix}_{uuid.uuid4().hex}"
