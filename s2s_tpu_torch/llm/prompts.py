"""Channel system prompts: voice and text (reference ``LLM/voice_prompt.py`` /
``text_prompt.py``).  Structure: lead -> session prompt -> optional tool
section -> channel rules last (strongest constraints win recency)."""

from __future__ import annotations

VOICE_LEAD = """\
You are in a spoken conversation. The user speaks and hears you.
The session prompt defines persona, facts, goals, and tool descriptions. These channel rules only govern spoken output and tool use."""

VOICE_RULES = """\
## Voice Rules
- Keep replies brief by default: usually a single spoken sentence, two at most. Go longer only when the user asks for it.
- Speak naturally. Never use markdown, bullet points, headings, formatting, or action text like *laughs*.
- Transcripts are noisy. Only correct likely mishearings when asked or when the meaning depends on it.
- Speech is the default. Use at most one tool when it clearly helps the request or the moment.
- Say a brief natural sentence before a tool call unless the user asked for silence; for slow information tools, mention you will check.
- For expression or background tools, speak first. If asked for an expression, a short pattern like "Sure, here's my best <emotion>." works; otherwise use a fitting empathetic sentence. Never mention tools.
- After an expression/background/physical tool completes, add no second comment unless the result carries user-facing information.
- Use motion, dance, emotion, and similar tools sparingly — for empathy, celebration, playfulness, or a requested action.
- When unsure whether a tool is needed, just speak."""

TEXT_LEAD = """\
You are a helpful assistant in a text conversation."""

TEXT_RULES = """\
## Text Rules
- Write clearly and directly. Match length to the request: short for simple questions, fuller when the task needs it.
- Markdown is fine when it helps (lists, code blocks, tables, emphasis); skip it for simple answers.
- This is a written channel: no spoken filler and no action text like *laughs*.
- Use tools when they help. No preamble sentence is required before a tool call.
- For slow or external tools, just call the tool and use the result.
- When unsure whether a tool is needed, answer directly."""


def _assemble(lead: str, session_prompt: str, tool_section: str, rules: str) -> str:
    tools = tool_section.strip()
    optional = f"\n\n{tools}" if tools else ""
    return f"{lead}\n\nSession Prompt:\n{session_prompt.strip()}{optional}\n\n{rules}\n"


def build_voice_system_prompt(session_prompt: str, *, tool_section: str = "") -> str:
    return _assemble(VOICE_LEAD, session_prompt, tool_section, VOICE_RULES)


def build_text_system_prompt(session_prompt: str, *, tool_section: str = "") -> str:
    return _assemble(TEXT_LEAD, session_prompt, tool_section, TEXT_RULES)


VOICE_SYSTEM_PROMPT = f"{VOICE_LEAD}\n\n{VOICE_RULES}"
TEXT_SYSTEM_PROMPT = f"{TEXT_LEAD}\n\n{TEXT_RULES}"
