"""WebRTC transport (reference ``api/openai_realtime/webrtc_session.py``).

The transport-agnostic pieces — the stateful PCM resampler and the
server-paced audio track buffer with barge-in ``clear()`` — are implemented
and tested standalone.  The aiortc peer-connection wiring (SDP negotiation,
``oai-events`` data channel, RTP track) activates only when ``aiortc`` is
installed (absent from this image); ``WEBRTC_AVAILABLE`` gates the
``POST /v1/realtime/calls`` route.
"""

from __future__ import annotations

import fractions
import logging
import threading
import time
from collections import deque
from math import gcd

import numpy as np

logger = logging.getLogger(__name__)

try:  # pragma: no cover - optional dependency
    import aiortc  # noqa: F401

    WEBRTC_AVAILABLE = True
except ImportError:
    WEBRTC_AVAILABLE = False

PIPELINE_RATE = 16_000
RTC_RATE = 48_000
FRAME_MS = 20


class PcmResampler:
    """Stateful streaming polyphase resampler (48 kHz <-> 16 kHz and friends).

    Blocks are resampled with filter context carried across calls so chunk
    boundaries don't click (the reference delegates this to a stateful
    ``av.AudioResampler``).
    """

    def __init__(self, src_rate: int, dst_rate: int) -> None:
        import scipy.signal

        self.src_rate = src_rate
        self.dst_rate = dst_rate
        g = gcd(src_rate, dst_rate)
        self.up, self.down = dst_rate // g, src_rate // g
        if src_rate == dst_rate:
            self._tail = np.zeros(0, np.float32)
            return
        max_rate = max(self.up, self.down)
        half_len = 10 * max_rate
        self._fir = (scipy.signal.firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
                     * self.up).astype(np.float32)
        #: context carried between blocks (in source samples)
        self._ctx_len = (len(self._fir) // 2) // self.up * 2 + self.down * 2
        self._tail = np.zeros(0, np.float32)
        self._emitted = 0
        self._consumed = 0

    def push(self, pcm: np.ndarray) -> np.ndarray:
        """Feed int16/float32 source samples; returns resampled float32."""
        import scipy.signal

        if self.src_rate == self.dst_rate:
            # same output contract as the resampled path: float32 in ±1.0
            return pcm.astype(np.float32) / (32768.0 if pcm.dtype == np.int16 else 1.0)
        x = pcm.astype(np.float32) / (32768.0 if pcm.dtype == np.int16 else 1.0)
        buf = np.concatenate([self._tail, x])
        self._consumed += len(x)
        # resample the whole buffered window, emit only the new region
        y = scipy.signal.resample_poly(buf, self.up, self.down, window=("kaiser", 5.0))
        start_src = self._consumed - len(buf)  # absolute index of buf[0]
        total_out = len(y)
        out_start_abs = (start_src * self.up) // self.down
        want_from = self._emitted - out_start_abs
        out = y[max(0, want_from) : total_out - self._out_guard()]
        self._emitted += len(out)
        keep = min(len(buf), self._ctx_len)
        self._tail = buf[len(buf) - keep :]
        return out.astype(np.float32)

    def _out_guard(self) -> int:
        """Output samples near the buffer end that may still change when more
        input arrives (filter half-width)."""
        return (self._ctx_len // 2) * self.up // self.down

    def flush(self) -> np.ndarray:
        import scipy.signal

        if self.src_rate == self.dst_rate or not len(self._tail):
            return np.zeros(0, np.float32)
        y = scipy.signal.resample_poly(self._tail, self.up, self.down, window=("kaiser", 5.0))
        start_abs = ((self._consumed - len(self._tail)) * self.up) // self.down
        out = y[self._emitted - start_abs :]
        self._tail = np.zeros(0, np.float32)
        return out.astype(np.float32)


class PacedAudioBuffer:
    """Server-paced outbound audio: fixed 20 ms frames, silence filled, with
    ``clear()`` for barge-in (reference ``PipelineAudioTrack``).

    Transport-agnostic: the aiortc track calls :meth:`next_frame` every
    20 ms; tests drive it directly.
    """

    def __init__(self, rate: int = PIPELINE_RATE, frame_ms: int = FRAME_MS) -> None:
        self.rate = rate
        self.frame_samples = rate * frame_ms // 1000
        self._chunks: deque[np.ndarray] = deque()
        self._lock = threading.Lock()
        self._offset = 0  # inside the head chunk
        self.frames_emitted = 0
        self.silence_frames = 0

    def append(self, pcm: np.ndarray) -> None:
        with self._lock:
            self._chunks.append(np.asarray(pcm, np.int16))

    def clear(self) -> int:
        """Drop all unplayed audio; returns the number of samples dropped."""
        with self._lock:
            dropped = sum(len(c) for c in self._chunks) - self._offset
            self._chunks.clear()
            self._offset = 0
            return max(0, dropped)

    @property
    def buffered_samples(self) -> int:
        with self._lock:
            return sum(len(c) for c in self._chunks) - self._offset

    def next_frame(self) -> np.ndarray:
        """Exactly ``frame_samples`` int16 samples; silence-filled when dry."""
        out = np.zeros(self.frame_samples, np.int16)
        filled = 0
        with self._lock:
            while filled < self.frame_samples and self._chunks:
                head = self._chunks[0]
                take = min(len(head) - self._offset, self.frame_samples - filled)
                out[filled : filled + take] = head[self._offset : self._offset + take]
                filled += take
                self._offset += take
                if self._offset >= len(head):
                    self._chunks.popleft()
                    self._offset = 0
        self.frames_emitted += 1
        if filled == 0:
            self.silence_frames += 1
        return out


def load_rtc():
    """Real aiortc/av namespace (``WebRTCCallManager`` takes any object with
    the same attributes, so tests inject fakes)."""
    from types import SimpleNamespace

    import aiortc
    import av

    return SimpleNamespace(
        RTCPeerConnection=aiortc.RTCPeerConnection,
        RTCSessionDescription=aiortc.RTCSessionDescription,
        RTCConfiguration=aiortc.RTCConfiguration,
        RTCIceServer=aiortc.RTCIceServer,
        MediaStreamTrack=aiortc.mediastreams.MediaStreamTrack,
        MediaStreamError=aiortc.mediastreams.MediaStreamError,
        AudioFrame=av.AudioFrame,
    )


def make_pipeline_track(rtc):
    """RTP track fed by a PacedAudioBuffer at 48 kHz, server-paced 20 ms
    frames with silence fill (reference ``PipelineAudioTrack``,
    ``webrtc_session.py:99-152``).  Built against the injected rtc namespace
    so tests run it with fakes."""
    import asyncio

    class _PipelineAudioTrack(rtc.MediaStreamTrack):
        kind = "audio"

        def __init__(self) -> None:
            super().__init__()
            self.buffer = PacedAudioBuffer(rate=RTC_RATE)
            self._timestamp = 0
            self._t0 = None

        async def recv(self):
            # timestamp-anchored pacing: wait until start + n*20 ms so
            # per-iteration overhead doesn't accumulate as playout drift
            import time as _time

            if self._t0 is None:
                self._t0 = _time.monotonic()
            target = self._t0 + (self._timestamp / RTC_RATE)
            delay = target - _time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            samples = self.buffer.next_frame()
            frame = rtc.AudioFrame.from_ndarray(samples[None, :], format="s16", layout="mono")
            frame.sample_rate = RTC_RATE
            frame.pts = self._timestamp
            frame.time_base = fractions.Fraction(1, RTC_RATE)
            self._timestamp += len(samples)
            return frame

    return _PipelineAudioTrack()


class WebRTCTransport:
    """Events over the ``oai-events`` data channel (ordered via an asyncio
    queue + sender task, reference ``webrtc_session.py:186-189``); audio on
    the RTP track."""

    kind = "webrtc"

    def __init__(self, pc, channel, track) -> None:
        import asyncio

        self.pc = pc
        self.channel = channel
        self.track = track
        self._out16_to_48 = PcmResampler(PIPELINE_RATE, RTC_RATE)
        self._events: "asyncio.Queue[dict]" = asyncio.Queue()
        self._channel_open = asyncio.Event()
        self._closed = asyncio.Event()
        if getattr(channel, "readyState", None) == "open":
            self._channel_open.set()
        else:
            channel.on("open", self._channel_open.set)

    async def run_sender(self) -> None:
        """Drain queued events to the channel in order, once it opens.
        Exits when the transport closes (no leaked per-call task)."""
        import asyncio
        import json

        while not self._closed.is_set():
            if self._channel_open.is_set():
                break
            await asyncio.sleep(0.05)
        while not self._closed.is_set():
            try:
                event = await asyncio.wait_for(self._events.get(), timeout=0.25)
            except asyncio.TimeoutError:
                continue
            try:
                self.channel.send(json.dumps(event))
            except Exception:  # noqa: BLE001
                logger.debug("webrtc: data channel send failed")

    async def send_events(self, events) -> None:
        for event in events:
            self._events.put_nowait(event)

    async def send_audio_chunk(self, service, session_id, pcm: bytes) -> None:
        samples = np.frombuffer(pcm, np.int16)
        up = self._out16_to_48.push(samples)
        self.track.buffer.append(np.clip(up * 32768, -32768, 32767).astype(np.int16))
        # bookkeeping events (response.created etc.) still go on the channel
        _, _, _, events = service.begin_audio_output(session_id)
        if events:
            await self.send_events(events)

    def discard_pending_audio(self) -> None:
        dropped = self.track.buffer.clear()
        if dropped:
            logger.info("webrtc: dropped %d unplayed samples (barge-in)", dropped)

    async def close(self) -> None:
        self._closed.set()
        try:
            await self.pc.close()
        except Exception:  # noqa: BLE001
            pass


class PoolBusyError(RuntimeError):
    """All pipeline slots are claimed."""


class WebRTCCallManager:
    """``POST /v1/realtime/calls``: negotiate SDP, claim a pipeline unit,
    pump data-channel events and inbound RTP audio, watchdog the connect
    (reference ``webrtc_session.py`` + ``websocket_router.py:579-720``)."""

    def __init__(
        self,
        pool,
        stop_event,
        rtc=None,
        connect_timeout_s: float = 30.0,
        ice_servers: list[str] | None = None,
    ) -> None:
        self.pool = pool
        self.stop_event = stop_event
        self._rtc = rtc if rtc is not None else load_rtc()
        self.connect_timeout_s = connect_timeout_s
        self.ice_servers = ice_servers or []
        self._tasks: set = set()
        #: live calls by id: the POST response's Location header names one,
        #: DELETE /v1/realtime/calls/{id} hangs it up (reference
        #: websocket_router.py:579-720 call lifecycle)
        self.calls: dict = {}

    def _pc_config(self):
        rtc = self._rtc
        if not self.ice_servers or not hasattr(rtc, "RTCConfiguration"):
            return None
        return rtc.RTCConfiguration(iceServers=[rtc.RTCIceServer(urls=u) for u in self.ice_servers])

    def _spawn(self, coro) -> None:
        import asyncio

        task = asyncio.get_event_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def handle_offer(self, offer_sdp: str) -> str:
        """Negotiate one call; returns the answer SDP (id-less variant)."""
        _, sdp = await self.handle_call(offer_sdp)
        return sdp

    async def hangup(self, call_id: str) -> bool:
        """DELETE semantics: close the call's peer connection; the teardown
        task releases the unit.  Returns False for unknown/finished ids."""
        entry = self.calls.get(call_id)
        if entry is None:
            return False
        pc, closed = entry
        closed.set()
        try:
            await pc.close()
        except Exception:  # noqa: BLE001
            pass
        return True

    async def handle_call(self, offer_sdp: str) -> tuple[str, str]:
        """Negotiate one call; returns (call_id, answer SDP).  Raises
        :class:`PoolBusyError` when no unit is free."""
        import asyncio

        from s2s_tpu_torch.realtime.router import claim_unit, clean_unit

        rtc = self._rtc
        config = self._pc_config()
        pc = rtc.RTCPeerConnection(config) if config is not None else rtc.RTCPeerConnection()
        track = make_pipeline_track(rtc)
        pc.addTrack(track)
        channel = pc.createDataChannel("oai-events", ordered=True)
        transport = WebRTCTransport(pc, channel, track)

        unit = claim_unit(self.pool, transport)
        if unit is None:
            await pc.close()
            raise PoolBusyError(f"All {len(self.pool)} session slots are in use")
        session_id = unit.service.register()
        unit.session.session_id = session_id
        clean_unit(unit)
        closed = asyncio.Event()

        self._spawn(transport.run_sender())
        await transport.send_events([unit.service.build_session_created(session_id)])

        inbound: "asyncio.Queue" = asyncio.Queue()
        loop = asyncio.get_event_loop()

        @channel.on("message")
        def on_message(message) -> None:
            loop.call_soon_threadsafe(inbound.put_nowait, message)

        self._spawn(self._pump_channel(unit, session_id, transport, inbound, closed))

        @pc.on("track")
        def on_track(remote_track) -> None:
            if getattr(remote_track, "kind", "audio") == "audio":
                self._spawn(self._pump_audio(unit, session_id, remote_track, closed))

        @pc.on("connectionstatechange")
        def on_state() -> None:
            if pc.connectionState in ("failed", "closed"):
                loop.call_soon_threadsafe(closed.set)

        self._spawn(self._watchdog(pc, unit, session_id, closed))
        self._spawn(self._teardown_when_closed(unit, session_id, closed))

        try:
            await pc.setRemoteDescription(rtc.RTCSessionDescription(sdp=offer_sdp, type="offer"))
            answer = await pc.createAnswer()
            await pc.setLocalDescription(answer)  # aiortc gathers ICE here
        except Exception:
            # invalid offer / negotiation failure AFTER the claim: the unit
            # must go back to the pool (the teardown task releases it)
            closed.set()
            try:
                await pc.close()
            except Exception:  # noqa: BLE001
                pass
            raise
        call_id = f"rtc_{session_id}"
        self.calls[call_id] = (pc, closed)
        self._spawn(self._forget_when_closed(call_id, closed))
        logger.info(
            "WebRTC call %s negotiated on pipeline %d (session %s)",
            call_id, unit.index, session_id,
        )
        return call_id, pc.localDescription.sdp

    async def _forget_when_closed(self, call_id, closed) -> None:
        await closed.wait()
        self.calls.pop(call_id, None)

    async def _pump_channel(self, unit, session_id, transport, inbound, closed) -> None:
        import asyncio
        import json

        from s2s_tpu_torch.realtime.router import dispatch_client_event

        while not closed.is_set() and not self.stop_event.is_set():
            try:
                message = await asyncio.wait_for(inbound.get(), timeout=0.1)
            except asyncio.TimeoutError:
                continue
            try:
                raw = json.loads(message)
            except (TypeError, json.JSONDecodeError):
                await transport.send_events(
                    [unit.service.make_error("Malformed JSON frame", "invalid_json")]
                )
                continue
            await dispatch_client_event(
                unit, session_id, raw, transport, transport_kind="webrtc"
            )

    async def _pump_audio(self, unit, session_id, remote_track, closed) -> None:
        """Incoming RTP audio -> stateful resample to 16 kHz -> 512-sample
        pipeline chunks."""
        resamplers: dict[int, PcmResampler] = {}
        while not closed.is_set() and not self.stop_event.is_set():
            try:
                frame = await remote_track.recv()
            except Exception:  # MediaStreamError / cancelled
                break
            pcm, rate = frame_to_mono_int16(frame)
            resampler = resamplers.get(rate)
            if resampler is None:
                resampler = resamplers.setdefault(rate, PcmResampler(rate, PIPELINE_RATE))
            out = resampler.push(pcm)
            if not len(out):
                continue
            data = np.clip(out * 32768.0, -32768, 32767).astype(np.int16).tobytes()
            try:
                chunks = unit.service.append_pcm(session_id, data, PIPELINE_RATE)
            except KeyError:  # session already unregistered
                break
            rt_cfg = unit.service._state(session_id).runtime_config
            for chunk in chunks:
                unit.input_queue.put((chunk, rt_cfg))

    async def _watchdog(self, pc, unit, session_id, closed) -> None:
        import asyncio

        try:
            await asyncio.wait_for(closed.wait(), timeout=self.connect_timeout_s)
        except asyncio.TimeoutError:
            if getattr(pc, "connectionState", "connected") not in ("connected",):
                logger.warning("WebRTC connect watchdog fired (session %s)", session_id)
                closed.set()
                await pc.close()

    async def _teardown_when_closed(self, unit, session_id, closed) -> None:
        from s2s_tpu_torch.realtime.router import release_session

        await closed.wait()
        if unit.session is not None and unit.session.session_id == session_id:
            transport = unit.session.transport
            if transport is not None and hasattr(transport, "_closed"):
                transport._closed.set()  # stop the per-call sender task
            release_session(unit, session_id)
            logger.info("WebRTC call released pipeline %d (session %s)", unit.index, session_id)


def frame_to_mono_int16(frame) -> tuple[np.ndarray, int]:
    """Decode an av.AudioFrame-like object to (mono int16, sample_rate).

    Handles both layouts av produces: PLANAR (one row per channel — rows
    are averaged) and PACKED/interleaved (one row of n*channels samples —
    de-interleaved then averaged).  Normalisation happens ONCE, keyed on
    the source dtype: float frames are ±1.0, integer frames are already at
    int16 scale.
    """
    arr = frame.to_ndarray()
    is_float = np.issubdtype(np.asarray(arr).dtype, np.floating)
    layout = getattr(frame, "layout", None)
    channels = getattr(layout, "channels", None)
    n_ch = len(channels) if channels is not None else (arr.shape[0] if arr.ndim == 2 else 1)
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2 and arr.shape[0] > 1:
        arr = arr.mean(axis=0)  # planar: one row per channel
    elif arr.ndim == 2:
        arr = arr[0]
        if n_ch > 1:  # packed: a single row of interleaved samples
            arr = arr.reshape(-1, n_ch).mean(axis=1)
    elif n_ch > 1:
        arr = arr.reshape(-1, n_ch).mean(axis=1)
    if is_float:
        arr = np.clip(arr, -1.0, 1.0) * 32767.0
    return np.clip(arr, -32768, 32767).astype(np.int16), int(frame.sample_rate)
