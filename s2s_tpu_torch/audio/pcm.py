"""PCM codecs and sample-format conversion (bit-exact CPU paths).

The wire format is 16 kHz mono PCM16 in 512-sample (32 ms) chunks
(reference ``api/openai_realtime/service.py:66-69``); G.711 u-law/a-law are
accepted for telephony clients (``audio/pcmu``, ``audio/pcma`` session
formats).
"""

from __future__ import annotations

import base64

import numpy as np

PIPELINE_SAMPLE_RATE = 16_000
CHUNK_SAMPLES = 512  # 32 ms at 16 kHz


def int16_to_float32(sound: np.ndarray) -> np.ndarray:
    """Normalize int16 PCM to float32 in [-1, 1) (Silero convention: scale by
    1/32768 only when non-silent; reference ``utils/utils.py::int2float``)."""
    abs_max = np.abs(sound).max() if sound.size else 0
    out = sound.astype(np.float32)
    if abs_max > 0:
        out *= 1.0 / 32768.0
    return out.squeeze()


def float32_to_int16(sound: np.ndarray) -> np.ndarray:
    return np.clip(sound * 32768.0, -32768, 32767).astype(np.int16)


def pcm16_bytes_to_array(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.int16)


def b64_to_pcm16(data_b64: str) -> np.ndarray:
    return pcm16_bytes_to_array(base64.b64decode(data_b64))


def pcm16_to_b64(audio: np.ndarray | bytes) -> str:
    raw = audio if isinstance(audio, bytes) else np.asarray(audio, dtype=np.int16).tobytes()
    return base64.b64encode(raw).decode("ascii")


# ── G.711 (u-law / a-law), table-driven, bit-exact ───────────────────

_ULAW_BIAS = 0x84
_ULAW_CLIP = 32635


def _build_ulaw_encode_table() -> np.ndarray:
    # Standard G.711 u-law compression of int16 -> uint8.
    table = np.zeros(65536, dtype=np.uint8)
    for i in range(65536):
        pcm = np.int32(np.int16(i - 32768))
        sign = 0x80 if pcm < 0 else 0x00
        mag = min(int(-pcm if pcm < 0 else pcm), _ULAW_CLIP) + _ULAW_BIAS
        exponent = 7
        mask = 0x4000
        while exponent > 0 and not (mag & mask):
            exponent -= 1
            mask >>= 1
        mantissa = (mag >> (exponent + 3)) & 0x0F
        table[i] = ~(sign | (exponent << 4) | mantissa) & 0xFF
    return table


def _build_ulaw_decode_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.int16)
    for i in range(256):
        u = ~i & 0xFF
        sign = u & 0x80
        exponent = (u >> 4) & 0x07
        mantissa = u & 0x0F
        mag = ((mantissa << 3) + _ULAW_BIAS) << exponent
        mag -= _ULAW_BIAS
        table[i] = -mag if sign else mag
    return table


def _build_alaw_encode_table() -> np.ndarray:
    table = np.zeros(65536, dtype=np.uint8)
    for i in range(65536):
        pcm = int(np.int16(i - 32768))
        sign = 0x80 if pcm >= 0 else 0x00
        mag = min(pcm if pcm >= 0 else -pcm - 1 if pcm == -32768 else -pcm, 32767)
        if mag >= 256:
            exponent = 7
            mask = 0x4000
            while exponent > 1 and not (mag & mask):
                exponent -= 1
                mask >>= 1
            mantissa = (mag >> (exponent + 3)) & 0x0F
            value = (exponent << 4) | mantissa
        else:
            value = mag >> 4
        table[i] = (value ^ 0x55) | sign
    return table


def _build_alaw_decode_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.int16)
    for i in range(256):
        a = i ^ 0x55
        sign = a & 0x80
        exponent = (a >> 4) & 0x07
        mantissa = a & 0x0F
        if exponent > 0:
            mag = ((mantissa << 4) + 0x108) << (exponent - 1)
        else:
            mag = (mantissa << 4) + 8
        table[i] = mag if sign else -mag
    return table


_ULAW_ENC = _build_ulaw_encode_table()
_ULAW_DEC = _build_ulaw_decode_table()
_ALAW_ENC = _build_alaw_encode_table()
_ALAW_DEC = _build_alaw_decode_table()


def pcm16_to_ulaw(audio: np.ndarray) -> bytes:
    idx = audio.astype(np.int32) + 32768
    return _ULAW_ENC[idx].tobytes()


def ulaw_to_pcm16(data: bytes) -> np.ndarray:
    return _ULAW_DEC[np.frombuffer(data, dtype=np.uint8)]


def pcm16_to_alaw(audio: np.ndarray) -> bytes:
    idx = audio.astype(np.int32) + 32768
    return _ALAW_ENC[idx].tobytes()


def alaw_to_pcm16(data: bytes) -> np.ndarray:
    return _ALAW_DEC[np.frombuffer(data, dtype=np.uint8)]


def decode_wire_audio(data: bytes, fmt: str) -> np.ndarray:
    """Decode client audio bytes to int16 PCM by session audio format type."""
    if fmt == "audio/pcmu":
        return ulaw_to_pcm16(data)
    if fmt == "audio/pcma":
        return alaw_to_pcm16(data)
    return pcm16_bytes_to_array(data)


def encode_wire_audio(audio: np.ndarray, fmt: str) -> bytes:
    if fmt == "audio/pcmu":
        return pcm16_to_ulaw(audio)
    if fmt == "audio/pcma":
        return pcm16_to_alaw(audio)
    return np.asarray(audio, dtype=np.int16).tobytes()
