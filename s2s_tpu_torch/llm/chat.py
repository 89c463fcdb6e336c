"""Bounded conversation store for realtime sessions.

Behavioral parity with reference ``LLM/chat.py`` (spec'd by its
``tests/test_chat.py``): a lock-protected buffer of conversation items whose
size is measured in *user turns*, with

- oldest-complete-turn eviction (sync) or LLM **compaction** into a summary
  user/assistant pair (background, single-flight) when the soft limit is
  exceeded, and a ``2 * size`` inline hard cap;
- function_call / function_call_output pairing: FCs wait in a pending map
  until their FCO arrives (and are re-injected if evicted meanwhile);
- speculative-turn support: in-place user message text replacement / removal
  by item id;
- transactional rollback of a failed generation's provisional items;
- audio-history placeholdering, image stripping;
- serializers for the Responses API wire shape and chat-template messages.

Items are the role-discriminated models from :mod:`s2s_tpu_torch.realtime.types`
(``MessageItem`` / ``FunctionCallItem`` / ``FunctionCallOutputItem``).
"""

from __future__ import annotations

import json
import logging
import threading
from collections.abc import Callable
from typing import Any

from pydantic import BaseModel

from s2s_tpu_torch.realtime.types import (
    ConversationItem,
    FunctionCallItem,
    FunctionCallOutputItem,
    InputTextContent,
    MessageItem,
    OutputTextContent,
    ResponseCreateParams,
    generate_id,
)

logger = logging.getLogger(__name__)

AUDIO_INPUT_HISTORY_PLACEHOLDER = "[User audio input]"


class ChatItemError(Exception):
    """A conversation item failed validation."""


class CompactionResult(BaseModel):
    user_summary: str
    assistant_summary: str


#: Summarizer: serialized older turns -> summary pair.
CompactFn = Callable[[list[dict[str, Any]]], CompactionResult]


def _with_id(value: str | None, prefix: str) -> str:
    if value is None:
        return generate_id(prefix)
    if not value.startswith(f"{prefix}_"):
        raise ChatItemError(f"ID must start with '{prefix}_', got {value!r}")
    return value


def _is_user(item: ConversationItem) -> bool:
    return isinstance(item, MessageItem) and item.role == "user"


def _is_assistant(item: ConversationItem) -> bool:
    return isinstance(item, MessageItem) and item.role == "assistant"


class Chat:
    """Bounded, thread-safe conversation history."""

    def __init__(self, size: int) -> None:
        self.size = size
        self.system_message: MessageItem | None = None
        self.buffer: list[ConversationItem] = []
        self._pending_tool_calls: dict[str, FunctionCallItem] = {}
        self._user_turns = 0
        self._lock = threading.Lock()
        self._compacting = False
        self._compact_thread: threading.Thread | None = None  # latest worker (join handle)
        self._epoch = 0  # bumped on reset/close to void in-flight compactions
        self._closed = threading.Event()

    # ── item intake ──────────────────────────────────────────────────

    def init_chat(self, message: MessageItem) -> None:
        with self._lock:
            self.system_message = message

    def add_item(self, item: ConversationItem) -> ConversationItem:
        """Validate and route an item into the buffer.

        The soft size limit is enforced by :meth:`trim_if_needed` (called
        after each generation); a ``2 * size`` hard cap is applied inline as
        a runaway-client safety net.
        """
        with self._lock:
            if isinstance(item, MessageItem) and item.role == "system":
                item.id = _with_id(item.id, "sys")
                self.system_message = item
            elif _is_user(item):
                item.id = _with_id(item.id, "msg")
                item.content = [
                    p
                    for p in item.content
                    if (getattr(p, "type", None) == "input_text" and getattr(p, "text", None))
                    or (getattr(p, "type", None) == "input_image" and getattr(p, "image_url", None))
                    or (getattr(p, "type", None) == "input_audio" and getattr(p, "audio", None))
                ]
                if not item.content:
                    raise ChatItemError(
                        "Message has no supported content. Supported modalities: "
                        "input_text, input_image, input_audio."
                    )
                self.buffer.append(item)
                self._user_turns += 1
            elif _is_assistant(item):
                item.id = _with_id(item.id, "msg")
                item.content = [
                    p
                    for p in item.content
                    if getattr(p, "type", None) == "output_text" and getattr(p, "text", None)
                ]
                if not item.content:
                    return item
                self.buffer.append(item)
            elif isinstance(item, FunctionCallItem):
                item.id = _with_id(item.id, "fc")
                item.call_id = _with_id(item.call_id, "call")
                self._pending_tool_calls[item.call_id] = item
            elif isinstance(item, FunctionCallOutputItem):
                item.id = _with_id(item.id, "fco")
                self._add_tool_output(item.call_id or "", item)
            else:
                raise ChatItemError(f"Unsupported item type: {getattr(item, 'type', None)}")

            if self.size > 0 and self._user_turns > 2 * self.size:
                logger.warning(
                    "Chat exceeded hard cap (%d > 2*%d); evicting", self._user_turns, self.size
                )
                while self._user_turns > 2 * self.size:
                    self._evict_oldest_turn()
            return item

    def append_tool_output(self, call_id: str, output_item: FunctionCallOutputItem) -> None:
        with self._lock:
            self._add_tool_output(call_id, output_item)

    def _add_tool_output(self, call_id: str, output_item: FunctionCallOutputItem) -> None:
        for entry in self.buffer:
            if isinstance(entry, FunctionCallItem) and entry.call_id == call_id:
                self._pending_tool_calls.pop(call_id, None)
                entry.status = output_item.status or "completed"
                self.buffer.append(output_item)
                return
        fc = self._pending_tool_calls.pop(call_id, None)
        if fc is not None:
            logger.info("Re-injecting evicted function_call for call_id=%s", call_id)
            fc.status = output_item.status or "completed"
            self.buffer.extend((fc, output_item))
            return
        raise ChatItemError(f"No function_call with call_id '{call_id}' found in conversation history.")

    # ── size management ──────────────────────────────────────────────

    def _evict_oldest_turn(self) -> None:
        """Drop items from the front up to the next user-message boundary."""
        if not self.buffer:
            return
        first = self.buffer.pop(0)
        if _is_user(first):
            self._user_turns -= 1
        while self.buffer and not _is_user(self.buffer[0]):
            self.buffer.pop(0)

    def trim_if_needed(self, compactor: CompactFn | None = None) -> None:
        """Enforce the soft limit after a completed generation."""
        with self._lock:
            if self._user_turns <= self.size:
                return
            if compactor is None:
                while self._user_turns > self.size:
                    self._evict_oldest_turn()
            else:
                self._start_compaction(compactor)

    # ── speculative-turn edits ───────────────────────────────────────

    def replace_user_message_text(self, item_id: str, text: str) -> bool:
        """Swap a user message's content for new text (revision supersedes)."""
        with self._lock:
            for item in self.buffer:
                if _is_user(item) and item.id == item_id:
                    item.content = [InputTextContent(text=text)]
                    return True
        return False

    def remove_user_message(self, item_id: str) -> bool:
        with self._lock:
            for index, item in enumerate(self.buffer):
                if _is_user(item) and item.id == item_id:
                    del self.buffer[index]
                    self._user_turns -= 1
                    return True
        return False

    def rollback_generation(self, user_message_id: str, *, item_ids: set[str], call_ids: set[str]) -> None:
        """Remove only the provisional items one failed generation wrote.

        Matches both item ids and tool ``call_id``s (a fast client may append
        an FCO while generation is still streaming); concurrent items for a
        later turn survive.
        """
        with self._lock:
            kept: list[ConversationItem] = []
            for item in self.buffer:
                drop = item.id == user_message_id or item.id in item_ids
                if isinstance(item, (FunctionCallItem, FunctionCallOutputItem)):
                    drop = drop or item.call_id in call_ids
                if not drop:
                    kept.append(item)
            self.buffer = kept
            for call_id in call_ids:
                self._pending_tool_calls.pop(call_id, None)
            self._user_turns = sum(1 for item in self.buffer if _is_user(item))

    # ── media management ─────────────────────────────────────────────

    def compact_audio_history(self, max_audio_turns: int) -> None:
        """Keep audio only on the newest *max_audio_turns* user turns; older
        audio parts collapse into one text placeholder per message."""
        with self._lock:
            budget = max(0, max_audio_turns)
            for item in reversed(self.buffer):
                if not _is_user(item):
                    continue
                if not any(getattr(p, "type", None) == "input_audio" for p in item.content):
                    continue
                if budget:
                    budget -= 1
                    continue
                new_content: list[Any] = []
                replaced = False
                for p in item.content:
                    if getattr(p, "type", None) != "input_audio":
                        new_content.append(p)
                    elif not replaced:
                        new_content.append(InputTextContent(text=AUDIO_INPUT_HISTORY_PLACEHOLDER))
                        replaced = True
                item.content = new_content

    def image_message_ids(self) -> set[str]:
        with self._lock:
            return {
                item.id
                for item in self.buffer
                if _is_user(item)
                and item.id is not None
                and any(getattr(p, "type", None) == "input_image" for p in item.content)
            }

    def strip_images(self, only_ids: set[str] | None = None) -> None:
        """Drop image parts (optionally only from *only_ids*) so images don't
        persist across turns; a mid-generation image for the next turn is kept
        when *only_ids* is given."""
        with self._lock:
            for item in self.buffer:
                if _is_user(item) and (only_ids is None or item.id in only_ids):
                    item.content = [p for p in item.content if getattr(p, "type", None) != "input_image"]

    # ── lifecycle ────────────────────────────────────────────────────

    def copy(self) -> "Chat":
        with self._lock:
            clone = Chat(self.size)
            clone.system_message = self.system_message
            clone.buffer = list(self.buffer)
            clone._pending_tool_calls = dict(self._pending_tool_calls)
            clone._user_turns = self._user_turns
            return clone

    def reset(self) -> None:
        with self._lock:
            self._epoch += 1
            self._compacting = False
            self.buffer = []
            self.system_message = None
            self._pending_tool_calls = {}
            self._user_turns = 0

    def close(self) -> None:
        """Shut down; any in-flight compaction splice is suppressed (the
        worker daemon thread is reaped at process exit)."""
        self._closed.set()
        with self._lock:
            self._epoch += 1
            self._compacting = False

    @property
    def user_turn_count(self) -> int:
        return self._user_turns

    # ── serializers ──────────────────────────────────────────────────

    def to_responses_input(self, items: list[ConversationItem] | None = None) -> list[dict[str, Any]]:
        """Serialize (system + buffer) for the OpenAI Responses API ``input``."""
        with self._lock:
            return self._serialize_responses(self.buffer if items is None else items)

    def _serialize_responses(self, items: list[ConversationItem]) -> list[dict[str, Any]]:
        out: list[dict[str, Any]] = []
        if self.system_message:
            out.append(
                {
                    "type": "message",
                    "role": "system",
                    "content": [
                        {"type": "input_text", "text": p.text or "A helpful AI assistant."}
                        for p in self.system_message.content
                    ],
                }
            )
        for item in items:
            if _is_user(item):
                content: list[dict[str, Any]] = []
                audio_seen = False
                for p in item.content:
                    t = getattr(p, "type", None)
                    if t == "input_text" and getattr(p, "text", None) is not None:
                        content.append({"type": "input_text", "text": p.text or ""})
                    elif t == "input_image" and getattr(p, "image_url", None) is not None:
                        content.append(
                            {
                                "type": "input_image",
                                "detail": getattr(p, "detail", None) or "auto",
                                "image_url": p.image_url,
                            }
                        )
                    elif t == "input_audio" and not audio_seen:
                        content.append({"type": "input_text", "text": AUDIO_INPUT_HISTORY_PLACEHOLDER})
                        audio_seen = True
                if content:
                    out.append({"type": "message", "role": "user", "content": content})
            elif _is_assistant(item):
                texts = [
                    {"type": "output_text", "text": p.text, "annotations": []}
                    for p in item.content
                    if getattr(p, "type", None) == "output_text" and getattr(p, "text", None) is not None
                ]
                if texts:
                    out.append(
                        {
                            "type": "message",
                            "role": "assistant",
                            "id": item.id,
                            "status": item.status or "completed",
                            "content": texts,
                        }
                    )
            elif isinstance(item, FunctionCallItem) and item.call_id:
                fc: dict[str, Any] = {
                    "type": "function_call",
                    "call_id": item.call_id,
                    "name": item.name,
                    "arguments": item.arguments,
                    "id": item.id,
                }
                if item.status is not None:
                    fc["status"] = item.status
                out.append(fc)
            elif isinstance(item, FunctionCallOutputItem):
                fco: dict[str, Any] = {
                    "type": "function_call_output",
                    "call_id": item.call_id,
                    "output": item.output,
                }
                if item.id is not None:
                    fco["id"] = item.id
                if item.status is not None:
                    fco["status"] = item.status
                out.append(fco)
        return out

    def to_chat_messages(self) -> list[dict[str, Any]]:
        """Serialize for chat-template / Chat Completions style consumers.

        Text-only user messages flatten to a plain string ``content``; media
        messages keep the structured list.  Tool calls become assistant
        ``tool_calls`` entries (with ``content`` present, as chat templates
        expect) and FCOs become role ``tool`` messages.
        """
        with self._lock:
            msgs: list[dict[str, Any]] = []
            if self.system_message:
                text = " ".join(p.text for p in self.system_message.content if getattr(p, "text", None))
                msgs.append({"role": "system", "content": text})
            for item in self.buffer:
                if _is_user(item):
                    has_media = any(
                        getattr(p, "type", None) in {"input_image", "input_audio"} for p in item.content
                    )
                    if has_media:
                        msgs.append(
                            {
                                "role": "user",
                                "content": [p.model_dump(exclude_none=True) for p in item.content],
                            }
                        )
                    else:
                        text = " ".join(
                            p.text
                            for p in item.content
                            if getattr(p, "type", None) == "input_text" and getattr(p, "text", None)
                        )
                        msgs.append({"role": "user", "content": text})
                elif _is_assistant(item):
                    text = " ".join(p.text for p in item.content if getattr(p, "text", None))
                    msgs.append({"role": "assistant", "content": text})
                elif isinstance(item, FunctionCallItem):
                    try:
                        args = json.loads(item.arguments) if isinstance(item.arguments, str) else item.arguments
                    except (json.JSONDecodeError, TypeError):
                        args = {}
                    msgs.append(
                        {
                            "role": "assistant",
                            "content": "",
                            "tool_calls": [
                                {
                                    "type": "function",
                                    "id": item.call_id,
                                    "function": {"name": item.name, "arguments": args},
                                }
                            ],
                        }
                    )
                elif isinstance(item, FunctionCallOutputItem):
                    name = ""
                    for prev in reversed(msgs):
                        for tc in prev.get("tool_calls", []):
                            if tc["id"] == item.call_id:
                                name = tc["function"]["name"]
                                break
                        if name:
                            break
                    msgs.append(
                        {
                            "role": "tool",
                            "tool_call_id": item.call_id,
                            "name": name,
                            "content": item.output,
                        }
                    )
            return msgs

    # ── background compaction ────────────────────────────────────────

    def _compaction_snapshot(self) -> tuple[list[dict[str, Any]], set[str], int]:
        """Items eligible for compaction: everything but the newest user turn.

        Caller holds the lock.  Returns ``(serialized, marker_ids, n_turns)``;
        empty when fewer than 2 compactable turns exist.
        """
        n_turns = max(0, self._user_turns - 1)
        if n_turns < 2:
            return [], set(), n_turns
        user_seen = 0
        end = len(self.buffer)
        for i, entry in enumerate(self.buffer):
            if _is_user(entry):
                user_seen += 1
                if user_seen == n_turns + 1:
                    end = i
                    break
        slice_ = self.buffer[:end]
        marker_ids = {e.id for e in slice_ if e.id is not None}
        snapshot = self._serialize_responses(slice_)
        for msg in snapshot:
            if msg.get("role") == "user" and isinstance(msg.get("content"), list):
                msg["content"] = [
                    c
                    for c in msg["content"]
                    if not (isinstance(c, dict) and c.get("type") in {"input_image", "input_audio"})
                ]
        return snapshot, marker_ids, n_turns

    def _start_compaction(self, compactor: CompactFn) -> None:
        """Launch the single-flight background summarization. Caller holds lock."""
        if self._closed.is_set() or self._compacting:
            return
        snapshot, marker_ids, n_turns = self._compaction_snapshot()
        if n_turns < 2 or not marker_ids:
            return
        epoch = self._epoch
        self._compacting = True
        thread = threading.Thread(
            target=self._compact_worker,
            args=(compactor, snapshot, marker_ids, epoch),
            daemon=True,
            name="chat-compact",
        )
        self._compact_thread = thread
        thread.start()
        logger.info("Chat compaction triggered for %d turn(s)", n_turns)

    def _compact_worker(
        self, compactor: CompactFn, snapshot: list[dict[str, Any]], marker_ids: set[str], epoch: int
    ) -> None:
        try:
            if self._closed.is_set() or self._epoch != epoch:
                return
            try:
                result = compactor(snapshot)
            except Exception:
                logger.exception("Chat compaction failed; chat unchanged")
                return
            if not isinstance(result, CompactionResult):
                logger.error("Compactor returned %r, expected CompactionResult", type(result).__name__)
                return
            self._splice_compaction(result, marker_ids, epoch)
        finally:
            with self._lock:
                if self._epoch == epoch:
                    self._compacting = False

    def _splice_compaction(self, result: CompactionResult, marker_ids: set[str], epoch: int) -> None:
        """Replace the compacted range with the summary pair, preserving any FC
        whose FCO lives outside the range (else the FCO would orphan)."""
        with self._lock:
            if self._closed.is_set() or self._epoch != epoch:
                return
            fco_calls_inside = {
                x.call_id
                for x in self.buffer
                if isinstance(x, FunctionCallOutputItem) and x.id in marker_ids
            }
            keep_fc_ids = {
                x.id
                for x in self.buffer
                if x.id in marker_ids
                and isinstance(x, FunctionCallItem)
                and x.call_id not in fco_calls_inside
            }
            drop = marker_ids - keep_fc_ids
            remaining = [x for x in self.buffer if x.id not in drop]
            user_msg = make_user_message(result.user_summary)
            user_msg.id = generate_id("msg")
            asst_msg = make_assistant_message(result.assistant_summary)
            asst_msg.id = generate_id("msg")
            self.buffer = [user_msg, asst_msg, *remaining]
            self._user_turns = sum(1 for x in self.buffer if _is_user(x))
            logger.info(
                "Chat compaction applied: %d item(s), %d user turn(s)", len(self.buffer), self._user_turns
            )


# ── factories ────────────────────────────────────────────────────────


def make_user_message(text: str) -> MessageItem:
    return MessageItem(role="user", content=[InputTextContent(text=text)])


def make_user_audio_message(audio_b64: str) -> MessageItem:
    from s2s_tpu_torch.realtime.types import InputAudioContent

    return MessageItem(role="user", content=[InputAudioContent(audio=audio_b64)])


def make_assistant_message(text: str) -> MessageItem:
    return MessageItem(role="assistant", content=[OutputTextContent(text=text)])


def make_system_message(text: str) -> MessageItem:
    return MessageItem(role="system", content=[InputTextContent(text=text)])


def add_supported_item(chat: Chat, item: ConversationItem) -> None:
    """Validate + add a protocol item (used by conversation.item.create and
    out-of-band ``response.input`` seeding)."""
    if isinstance(item, FunctionCallItem) and (
        item.call_id is None or not item.call_id.startswith("call_")
    ):
        # call_id must be client-supplied: FCOs reference it later.
        raise ChatItemError("function_call item is missing a call_id. The call_id should start with 'call_'.")
    if isinstance(item, (MessageItem, FunctionCallItem, FunctionCallOutputItem)):
        chat.add_item(item)
        return
    raise ChatItemError(f"Unsupported item type: {getattr(item, 'type', None)}")


def build_active_chat(original_chat: Chat, response: ResponseCreateParams | None) -> Chat:
    """Chat an out-of-band response generates against (OpenAI semantics for
    ``response.input``): ``None`` -> read-only copy of the conversation;
    ``[]`` -> fresh empty chat; ``[...]`` -> fresh chat seeded with items."""
    from s2s_tpu_torch.realtime.types import parse_item

    if response is not None and response.input is not None:
        fresh = Chat(original_chat.size)
        for raw in response.input:
            try:
                item = parse_item(raw) if isinstance(raw, dict) else raw
            except Exception as exc:  # malformed item -> caller's rejection path
                raise ChatItemError(f"Unsupported response.input item: {exc}") from exc
            add_supported_item(fresh, item)
        return fresh
    return original_chat.copy()
