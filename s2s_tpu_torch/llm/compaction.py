"""History-compaction summarizer (reference ``LLM/compaction_prompt.py``).

Renders older turns as a transcript, asks the LLM for a JSON pair of
summaries (user-side / assistant-side), tolerates code fences, and exposes
``build_compactor(generate_fn)`` producing the :data:`CompactFn` the chat
store's background worker consumes.
"""

from __future__ import annotations

import json
import logging
import re
from typing import Any, Callable

from s2s_tpu_torch.llm.chat import CompactionResult

logger = logging.getLogger(__name__)

#: (system_prompt, user_prompt) -> generated text
CompactGenerateFn = Callable[[str, str], str]

COMPACTION_SYSTEM_PROMPT = """\
You compress conversation history. Given a transcript of an earlier portion of a
conversation, produce a compact summary that preserves every fact, preference,
decision, open question, and tool result a future assistant turn might need.

Respond with ONLY a JSON object of this exact shape:
{"user_summary": "<first-person summary of what the user said/asked/decided>",
 "assistant_summary": "<first-person summary of what the assistant said/did, including tool outcomes>"}
"""


def render_transcript(snapshot: list[dict[str, Any]]) -> str:
    """Serialize a responses-format snapshot into a readable transcript."""
    lines: list[str] = []
    for msg in snapshot:
        t = msg.get("type")
        if t == "message":
            role = msg.get("role", "user")
            content = msg.get("content")
            if isinstance(content, list):
                text = " ".join(
                    c.get("text", "") for c in content if isinstance(c, dict) and c.get("text")
                )
            else:
                text = str(content or "")
            if text:
                lines.append(f"{role.upper()}: {text}")
        elif t == "function_call":
            lines.append(f"ASSISTANT calls {msg.get('name')}({msg.get('arguments')})")
        elif t == "function_call_output":
            lines.append(f"TOOL RESULT: {msg.get('output')}")
    return "\n".join(lines)


_FENCE_RE = re.compile(r"```(?:json)?\s*(.*?)```", re.DOTALL)


def extract_json(text: str) -> dict[str, Any]:
    """Parse a JSON object out of model text, tolerating fences and prose."""
    m = _FENCE_RE.search(text)
    if m:
        text = m.group(1)
    start = text.find("{")
    end = text.rfind("}")
    if start == -1 or end == -1 or end <= start:
        raise ValueError(f"No JSON object found in compactor output: {text[:200]!r}")
    return json.loads(text[start : end + 1])


def build_compactor(generate_fn: CompactGenerateFn):
    """Make a ``CompactFn`` for :meth:`s2s_tpu_torch.llm.chat.Chat.trim_if_needed`."""

    def compact(snapshot: list[dict[str, Any]]) -> CompactionResult:
        transcript = render_transcript(snapshot)
        raw = generate_fn(COMPACTION_SYSTEM_PROMPT, transcript)
        data = extract_json(raw)
        return CompactionResult(
            user_summary=str(data.get("user_summary", "")),
            assistant_summary=str(data.get("assistant_summary", "")),
        )

    return compact
