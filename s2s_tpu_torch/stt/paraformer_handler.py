"""Paraformer STT stage on PyTorch (port of ``s2s_tpu/stt/paraformer_handler.py``,
FunASR backend, Chinese by default) over the port's NAR model.

As in the JAX package it subclasses the Whisper stage for its skeleton
(duration buckets, progressive and final lanes, the streamer).  The
transcriber is the port's: Whisper's log-mel at 80 mels through the
log-mel kernel (one launch a transcription), LFR and CMVN on the device
(:func:`s2s_tpu_torch.models.paraformer.lfr_cmvn`), then one forward whose
token ids and count are read back once.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from s2s_tpu_torch.stt.progressive import DecodeResult
from s2s_tpu_torch.stt.whisper_handler import WhisperSTTHandler, bucket_duration

logger = logging.getLogger(__name__)


class ParaformerSTTHandler(WhisperSTTHandler):
    """Single-pass non-autoregressive STT: one device program per window."""

    def setup(self, language: str | None = "zh", **kwargs: Any) -> None:
        super().setup(language=language, **kwargs)

    def _build_transcriber(self, model_size, params, tokenizer, max_new_tokens):
        from s2s_tpu_torch.models import paraformer
        from s2s_tpu_torch.ops.log_mel import log_mel_spectrogram

        cfg = (
            paraformer.ParaformerConfig.test_tiny()
            if model_size == "tiny"
            else paraformer.ParaformerConfig()
        )
        if params is None:
            logger.warning("ParaformerSTTHandler: random-init weights (no checkpoint provided)")
            params = paraformer.init_params(cfg, torch.Generator(device=self.device).manual_seed(0), self.device)
        self._paraformer_cfg, self._paraformer_params, self._tokenizer = cfg, params, tokenizer
        n_mels = cfg.input_size // paraformer.LFR_M

        def transcribe(audio: np.ndarray) -> DecodeResult:
            seconds = len(audio) / self.sample_rate
            target = int(bucket_duration(max(seconds, 0.5)) * self.sample_rate)
            padded = np.zeros(target, np.float32)
            padded[: min(len(audio), target)] = audio[:target]
            # fbank (T, n_mels) -> LFR stack + CMVN (FunASR frontend), on the device
            fbank = log_mel_spectrogram(torch.from_numpy(padded).to(self.device), n_mels).T
            feats = paraformer.lfr_cmvn(fbank, params["cmvn_mean"], params["cmvn_scale"])
            n_valid = max(2, int(len(audio) / self.sample_rate * 100 / paraformer.LFR_N))
            tokens = paraformer.transcribe_tokens(params, cfg, feats, n_valid)
            if self._tokenizer is not None:
                text = self._tokenizer.decode(tokens).strip()
            else:
                text = " ".join(str(t) for t in tokens)
            return DecodeResult(text, (), self.language)

        return transcribe
