"""Realtime audio client (reference ``api/openai_realtime/audio_client.py``).

Drives a voice session over the WS protocol: streams mic audio up as
``input_audio_buffer.append``, plays ``response.output_audio.delta`` down,
clears playback on ``speech_started`` (barge-in echo cut), renders the live
transcript.

Audio IO backends:
- ``sounddevice`` when installed (mic/speaker callbacks, like the reference);
- headless **WAV mode** otherwise: read input from a wav file at realtime
  pace, write playback to a wav file (also what the soak tests use).
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import time
import wave
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

logger = logging.getLogger(__name__)

CHUNK_SAMPLES = 512


class PlaybackBuffer:
    """Accumulates assistant audio; cleared on barge-in.  ``take()`` feeds
    the speaker callback from the audio hardware thread (thread-safe)."""

    def __init__(self) -> None:
        import threading

        self._chunks: list[np.ndarray] = []
        self._offset = 0
        self._lock = threading.Lock()

    def append(self, pcm: np.ndarray) -> None:
        with self._lock:
            self._chunks.append(np.asarray(pcm, np.int16))

    def clear(self) -> int:
        with self._lock:
            dropped = sum(len(c) for c in self._chunks) - self._offset
            self._chunks.clear()
            self._offset = 0
            return max(0, dropped)

    def take(self, n: int) -> np.ndarray:
        """Exactly n samples, silence-padded when dry (speaker callback)."""
        out = np.zeros(n, np.int16)
        filled = 0
        with self._lock:
            while filled < n and self._chunks:
                head = self._chunks[0]
                take = min(len(head) - self._offset, n - filled)
                out[filled : filled + take] = head[self._offset : self._offset + take]
                filled += take
                self._offset += take
                if self._offset >= len(head):
                    self._chunks.pop(0)
                    self._offset = 0
        return out

    def drain(self) -> np.ndarray:
        with self._lock:
            if not self._chunks:
                return np.zeros(0, np.int16)
            out = np.concatenate(self._chunks)[self._offset :]
            self._chunks.clear()
            self._offset = 0
            return out


@dataclass
class TranscriptRenderer:
    """Terminal transcript: USER partials/finals + streamed ASSISTANT text.

    Assistant deltas accumulate per *stream* — the ``(response_id, item_id,
    output_index, content_index)`` identity — so interleaved responses each
    get their own line, ``…transcript.done`` never reprints text that was
    already streamed live, and servers that only send done-events (no
    deltas) still render a full line (reference ``audio_client.py:170-244``).
    """

    show: bool = True
    _partial: str = ""
    lines: list[str] = field(default_factory=list)
    _live_stream: Optional[tuple] = None
    _live_text: str = ""
    _streamed: set = field(default_factory=set)

    @staticmethod
    def _stream_key(event: dict) -> tuple:
        return (
            event.get("response_id"),
            event.get("item_id"),
            event.get("output_index"),
            event.get("content_index"),
        )

    # ── user side ────────────────────────────────────────────────────
    def on_user_partial(self, delta: str) -> None:
        self._partial = delta
        if self.show:
            print(f"\rUSER: {delta}", end="", flush=True)

    def on_user_final(self, transcript: str) -> None:
        self._partial = ""
        self.lines.append(f"USER: {transcript}")
        if self.show:
            print(f"\rUSER: {transcript}")

    def on_user_cancelled(self) -> None:
        """Input discarded (reopen/cancel): drop the live partial without
        duplicating it as a final line."""
        self._partial = ""

    # ── assistant side ───────────────────────────────────────────────
    def on_assistant_delta(self, event: dict) -> None:
        delta = event.get("delta") or ""
        if not delta:
            return
        key = self._stream_key(event)
        if self._live_stream != key:
            self._finish_live_assistant()
            delta = delta.lstrip()
            if not delta:
                return
            self._live_stream = key
            if self.show:
                print("ASSISTANT: ", end="", flush=True)
        self._streamed.add(key)
        self._live_text += delta
        if self.show:
            print(delta, end="", flush=True)

    def on_assistant_done(self, event: dict) -> None:
        key = self._stream_key(event)
        if self._live_stream == key:
            self._finish_live_assistant()
        if key in self._streamed:
            self._streamed.discard(key)  # streamed live — never reprint
            return
        # legacy done-only server: the transcript arrives only here
        transcript = event.get("transcript") or event.get("text") or ""
        if transcript:
            self._finish_live_assistant()
            self.lines.append(f"ASSISTANT: {transcript}")
            if self.show:
                print(f"ASSISTANT: {transcript}", flush=True)

    def on_response_done(self, response_id: Optional[str]) -> None:
        if self._live_stream is not None and self._live_stream[0] == response_id:
            self._finish_live_assistant()
        self._streamed = {k for k in self._streamed if k[0] != response_id}

    def _finish_live_assistant(self) -> None:
        if self._live_stream is None:
            return
        if self._live_text.rstrip():
            self.lines.append(f"ASSISTANT: {self._live_text.rstrip()}")
        if self.show:
            print("", flush=True)
        self._live_stream = None
        self._live_text = ""

    # backward-compatible single-delta entry point
    def on_assistant(self, delta: str) -> None:
        self.on_assistant_delta({"delta": delta})


SUPPORTED_PCM_RATES = (16000, 24000)


def build_session_update(instructions: Optional[str], voice: Optional[str], rate: int) -> dict[str, Any]:
    if rate not in SUPPORTED_PCM_RATES:
        raise ValueError(
            f"Unsupported PCM rate {rate}: the realtime protocol carries "
            f"{' or '.join(str(r) for r in SUPPORTED_PCM_RATES)} Hz"
        )
    session: dict[str, Any] = {
        "type": "realtime",
        "audio": {
            "input": {
                "format": {"type": "audio/pcm", "rate": rate},
                "turn_detection": {"type": "server_vad", "interrupt_response": True},
            },
            "output": {"format": {"type": "audio/pcm", "rate": rate}},
        },
    }
    if instructions:
        session["instructions"] = instructions
    if voice:
        session["audio"]["output"]["voice"] = voice
    return {"type": "session.update", "session": session}


async def run_wav_client(
    url: str,
    input_wav: str,
    output_wav: Optional[str] = None,
    instructions: Optional[str] = None,
    voice: Optional[str] = None,
    sample_rate: int = 16000,
    realtime_pace: bool = True,
    max_duration_s: float = 60.0,
    renderer: TranscriptRenderer | None = None,
) -> TranscriptRenderer:
    """Headless session: stream *input_wav* up, capture playback to
    *output_wav*.  Returns the transcript renderer for inspection."""
    import websockets.asyncio.client as ws_client

    renderer = renderer or TranscriptRenderer(show=False)
    playback: list[np.ndarray] = []

    with wave.open(input_wav) as w:
        src_rate = w.getframerate()
        audio = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    if src_rate != sample_rate:
        from s2s_tpu_torch.audio.resample import resample_pcm16

        audio = np.frombuffer(resample_pcm16(audio.tobytes(), src_rate, sample_rate), np.int16)

    async with ws_client.connect(url) as ws:
        created = json.loads(await ws.recv())
        assert created["type"] == "session.created"
        await ws.send(json.dumps(build_session_update(instructions, voice, sample_rate)))

        async def sender() -> None:
            step = CHUNK_SAMPLES * 4  # 128 ms per append
            for i in range(0, len(audio), step):
                chunk = audio[i : i + step]
                await ws.send(
                    json.dumps(
                        {
                            "type": "input_audio_buffer.append",
                            "audio": base64.b64encode(chunk.tobytes()).decode(),
                        }
                    )
                )
                if realtime_pace:
                    await asyncio.sleep(len(chunk) / sample_rate)

        send_task = asyncio.create_task(sender())
        deadline = time.monotonic() + max_duration_s
        try:
            while time.monotonic() < deadline:
                try:
                    raw = await asyncio.wait_for(ws.recv(), timeout=1.0)
                except asyncio.TimeoutError:
                    if send_task.done() and time.monotonic() > deadline - max_duration_s / 2:
                        break
                    continue
                event = json.loads(raw)
                etype = event.get("type")
                if etype == "response.output_audio.delta":
                    playback.append(np.frombuffer(base64.b64decode(event["delta"]), np.int16))
                elif etype == "input_audio_buffer.speech_started":
                    dropped = sum(len(p) for p in playback)
                    playback.clear()  # barge-in: captured output drops unplayed audio
                    if dropped:
                        logger.debug("barge-in: cleared %d samples of unplayed audio", dropped)
                elif etype == "conversation.item.input_audio_transcription.delta":
                    renderer.on_user_partial(event["delta"])
                elif etype == "conversation.item.input_audio_transcription.completed":
                    renderer.on_user_final(event["transcript"])
                elif etype in ("response.output_audio_transcript.delta", "response.output_text.delta"):
                    renderer.on_assistant_delta(event)
                elif etype in ("response.output_audio_transcript.done", "response.output_text.done"):
                    renderer.on_assistant_done(event)
                elif etype == "response.done":
                    renderer.on_response_done((event.get("response") or {}).get("id"))
                    if send_task.done():
                        break
        finally:
            send_task.cancel()

    if output_wav and playback:
        with wave.open(output_wav, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(np.concatenate(playback).tobytes())
    return renderer


class SoundDeviceIO:
    """Default live audio backend (mic/speaker callbacks on HW threads,
    reference ``audio_client.py:325-470``).  Tests inject fakes with the
    same two methods."""

    def __init__(self) -> None:
        try:
            import sounddevice
        except ImportError as exc:
            raise ImportError(
                "sounddevice is required for live mic/speaker mode. "
                "Install with: pip install 's2s-tpu[audio]'"
            ) from exc

        self._sd = sounddevice

    def open_input(self, rate: int, blocksize: int, callback):
        """callback(int16 ndarray) per block; returns a started stream with
        ``.stop()``/``.close()``."""

        def cb(indata, frames, time_info, status):  # audio HW thread
            if status:
                logger.debug("mic status: %s", status)
            callback(np.frombuffer(bytes(indata), np.int16))

        stream = self._sd.RawInputStream(
            samplerate=rate, blocksize=blocksize, channels=1, dtype="int16", callback=cb
        )
        stream.start()
        return stream

    def open_output(self, rate: int, blocksize: int, fill):
        """fill(n) -> int16 ndarray; returns a started stream."""

        def cb(outdata, frames, time_info, status):  # audio HW thread
            outdata[:] = fill(frames).tobytes()

        stream = self._sd.RawOutputStream(
            samplerate=rate, blocksize=blocksize, channels=1, dtype="int16", callback=cb
        )
        stream.start()
        return stream


async def run_live_client(
    url: str,
    *,
    instructions: Optional[str] = None,
    voice: Optional[str] = None,
    sample_rate: int = 16000,
    audio_io=None,
    stop_event=None,
    connect_retry_s: float = 10.0,
) -> TranscriptRenderer:
    """Live mic/speaker session: mic blocks -> bounded queue (drop on full)
    -> ``input_audio_buffer.append``; ``response.output_audio.delta`` ->
    PlaybackBuffer -> speaker; ``speech_started`` clears unplayed playback
    (barge-in echo cut)."""
    import queue as _queue

    import websockets

    audio_io = audio_io if audio_io is not None else SoundDeviceIO()
    playback = PlaybackBuffer()
    renderer = TranscriptRenderer()
    mic_q: "_queue.Queue[np.ndarray]" = _queue.Queue(maxsize=64)

    def on_mic(block: np.ndarray) -> None:
        try:
            mic_q.put_nowait(block)
        except _queue.Full:  # drop oldest-style: drop this block
            pass

    deadline = time.monotonic() + connect_retry_s
    ws = None
    while True:
        try:
            ws = await websockets.connect(url)
            break
        except OSError:
            if time.monotonic() >= deadline:
                raise
            await asyncio.sleep(0.5)

    mic_stream = audio_io.open_input(sample_rate, CHUNK_SAMPLES, on_mic)
    try:
        spk_stream = audio_io.open_output(sample_rate, CHUNK_SAMPLES, playback.take)
    except Exception:
        # never leave the mic held open (or the WS half-connected) when the
        # speaker fails to come up
        for meth in ("stop", "close"):
            try:
                getattr(mic_stream, meth)()
            except Exception:  # noqa: BLE001
                pass
        try:
            await ws.close()
        except Exception:  # noqa: BLE001
            pass
        raise
    try:
        await ws.send(json.dumps(build_session_update(instructions, voice, sample_rate)))

        async def sender() -> None:
            while stop_event is None or not stop_event.is_set():
                try:
                    block = await asyncio.to_thread(mic_q.get, True, 0.1)
                except _queue.Empty:
                    continue
                await ws.send(json.dumps({
                    "type": "input_audio_buffer.append",
                    "audio": base64.b64encode(block.tobytes()).decode(),
                }))

        send_task = asyncio.create_task(sender())
        try:
            while stop_event is None or not stop_event.is_set():
                try:
                    raw = await asyncio.wait_for(ws.recv(), timeout=0.2)
                except asyncio.TimeoutError:
                    continue
                except Exception:
                    break
                event = json.loads(raw)
                etype = event.get("type")
                if etype == "response.output_audio.delta":
                    playback.append(np.frombuffer(base64.b64decode(event["delta"]), np.int16))
                elif etype == "input_audio_buffer.speech_started":
                    dropped = playback.clear()
                    if dropped:
                        logger.debug("barge-in: cleared %d unplayed samples", dropped)
                elif etype == "conversation.item.input_audio_transcription.delta":
                    renderer.on_user_partial(event["delta"])
                elif etype == "conversation.item.input_audio_transcription.completed":
                    renderer.on_user_final(event["transcript"])
                elif etype in ("response.output_audio_transcript.delta", "response.output_text.delta"):
                    renderer.on_assistant_delta(event)
                elif etype in ("response.output_audio_transcript.done", "response.output_text.done"):
                    renderer.on_assistant_done(event)
                elif etype == "response.done":
                    response = event.get("response") or {}
                    renderer.on_response_done(response.get("id"))
                    if response.get("status") == "cancelled":
                        # cancelled mid-flight: anything unplayed is stale
                        dropped = playback.clear()
                        if dropped:
                            logger.debug("cancelled response: cleared %d unplayed samples", dropped)
        finally:
            send_task.cancel()
            try:
                await send_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
    finally:
        for stream in (mic_stream, spk_stream):
            for meth in ("stop", "close"):
                try:
                    getattr(stream, meth)()
                except Exception:  # noqa: BLE001
                    pass
        try:
            await ws.close()
        except Exception:  # noqa: BLE001
            pass
    return renderer


def run_realtime_audio_client(args) -> None:
    """``talk`` entry point: sounddevice live mode when present (and no
    --input_wav given), else headless WAV mode."""
    if not args.input_wav:
        try:
            import sounddevice  # noqa: F401
        except ImportError:
            raise SystemExit(
                "No sounddevice available: install with pip install 's2s-tpu[audio]' "
                "for live mode, or provide --input_wav (and optionally --output_wav)"
            ) from None
        asyncio.run(
            run_live_client(
                args.url,
                instructions=args.instructions,
                voice=args.voice,
                sample_rate=args.sample_rate,
            )
        )
        return
    renderer = asyncio.run(
        run_wav_client(
            args.url,
            args.input_wav,
            args.output_wav,
            instructions=args.instructions,
            voice=args.voice,
            sample_rate=args.sample_rate,
        )
    )
    for line in renderer.lines:
        print(line)
