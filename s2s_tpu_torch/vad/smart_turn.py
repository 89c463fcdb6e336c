"""Semantic end-of-turn classification (Smart Turn), port of
``s2s_tpu/vad/smart_turn.py``.

A Whisper-encoder classifier over the last 8 s of a segment: the log-mel
kernel (:mod:`s2s_tpu_torch.ops.log_mel`), the port's Whisper encoder
(:mod:`s2s_tpu_torch.models.whisper`, whose attention is the flash kernel),
then mean-pool, a linear head and a sigmoid.  Where the JAX package jits
that chain, here it is a plain function on tensors on an explicit device.
``SmartTurnResult`` and ``prepare_audio`` are the JAX package's, copied.

``predict_fn`` is injectable for tests (scripted analyzers).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from s2s_tpu_torch import weights
from s2s_tpu_torch.models import whisper
from s2s_tpu_torch.models.common import Params
from s2s_tpu_torch.ops.log_mel import log_mel_spectrogram

MAX_WINDOW_S = 8.0
SAMPLE_RATE = 16_000


@dataclass(frozen=True)
class SmartTurnResult:
    complete: bool
    probability: float
    inference_ms: float


def prepare_audio(audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Keep the trailing <= 8 s, zero-pad the front to exactly 8 s."""
    target = int(MAX_WINDOW_S * sample_rate)
    audio = np.asarray(audio, dtype=np.float32)
    if len(audio) > target:
        audio = audio[-target:]
    if len(audio) < target:
        audio = np.concatenate([np.zeros(target - len(audio), np.float32), audio])
    return audio


def run(params: Params, cfg: whisper.WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """p(complete) of mel (1, n_mels, T): encode, mean-pool, head, sigmoid;
    a 0-d f32 tensor on the device."""
    enc = whisper.encode(params, cfg, mel)  # (1, T, d)
    pooled = torch.mean(enc.float(), dim=1)
    logit = pooled @ params["head"]["w"].float() + params["head"]["b"].float()
    return torch.sigmoid(logit)[0, 0]


class SmartTurnAnalyzer:
    """End-of-turn classifier: p(complete) over the last 8 s of a segment."""

    def __init__(
        self,
        threshold: float = 0.5,
        predict_fn: Callable[[np.ndarray], float] | None = None,
        encoder_params: Params | None = None,
        config: whisper.WhisperConfig | None = None,
        seed: int = 0,
        device: torch.device | str = "cpu",
    ) -> None:
        """*encoder_params*: a tree in the JAX package's layout, as
        :func:`load_checkpoint` returns it (with or without ``head``);
        converted to *device* here.  Without it the encoder and head are
        random from *seed* (the head from *seed* + 1)."""
        self.threshold = threshold
        if predict_fn is not None:
            self._predict = predict_fn
            return
        device = torch.device(device)
        cfg = config or whisper.WhisperConfig.tiny()
        if encoder_params is not None and "head" in encoder_params:
            params = weights.whisper_to_torch(encoder_params, device)
        else:
            enc = (weights.whisper_to_torch(encoder_params, device) if encoder_params is not None
                   else whisper.init_params(cfg, torch.Generator(device=device).manual_seed(seed), device))
            gen = torch.Generator(device=device).manual_seed(seed + 1)
            params = {
                **enc,
                "head": {
                    "w": torch.randn((cfg.d_model, 1), generator=gen, device=device) * cfg.d_model ** -0.5,
                    "b": torch.zeros(1, device=device),
                },
            }

        def predict(audio: np.ndarray) -> float:
            mel = log_mel_spectrogram(torch.from_numpy(audio).to(device), cfg.n_mels)[None]  # (1, n_mels, T)
            return float(run(params, cfg, mel))

        self._predict = predict

    def predict(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> SmartTurnResult:
        t0 = time.perf_counter()
        prob = float(self._predict(prepare_audio(audio, sample_rate)))
        ms = (time.perf_counter() - t0) * 1000.0
        return SmartTurnResult(complete=prob > self.threshold, probability=prob, inference_ms=ms)


def load_checkpoint(path: str) -> Params:
    """Load a converted Smart-Turn .npz (the JAX package's
    ``convert_state_dict`` layout) as a numpy tree."""
    from s2s_tpu_torch.registry import _load_checkpoint

    return _load_checkpoint(path)
