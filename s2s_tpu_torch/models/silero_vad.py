"""Streaming voice-activity model (Silero-VAD v5 architecture) in PyTorch,
the port of ``s2s_tpu/models/silero_vad.py``.

Per 512-sample/32 ms chunk at 16 kHz, with the JAX package's layouts and
numerics (f32 throughout):

- 64-sample context carried from the previous chunk (576-sample window);
- STFT magnitude (filter_length 256, hop 128: 3 frames) as a product with a
  fixed hann-windowed DFT basis;
- 4 convolutions (129->128->64->64->128, k=3, stride 1/2/2/1, padding 1),
  each followed by a ReLU, then a mean over time;
- an LSTM cell (128, gates i, f, g, o) carried across chunks;
- a 1x1 head + sigmoid -> speech probability.

The convolutions are written as products over 3-tap windows, not as
``conv1d``: cuDNN may run an f32 convolution in TF32 under PyTorch's
defaults (``torch.backends.cudnn.allow_tf32``), while an f32 product stays
f32 under them (``torch.backends.cuda.matmul.allow_tf32`` is off), and the
serve must not flip a process-wide flag that other models' numerics depend
on.  Convolution weights are PyTorch's ``(out, in, k)``;
:func:`s2s_tpu_torch.weights.silero_params` carries the JAX package's
``(k, in, out)`` trees across, and :func:`convert_silero_state_dict` maps
the published checkpoint onto such a tree.  The step has a batch dimension
for concurrent sessions (:class:`s2s_tpu_torch.runtime.batcher.BatchedSileroVAD`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from s2s_tpu_torch.models.common import HostStateDict, tree_to_device
from s2s_tpu_torch.models.decoder_lm import normal

Params = dict[str, Any]

CHUNK = 512
CONTEXT = 64
SR = 16_000

_STFT_N = 256
_STFT_HOP = 128
_N_BINS = _STFT_N // 2 + 1  # 129
_CONV_DIMS = ((_N_BINS, 128), (128, 64), (64, 64), (64, 128))
_CONV_STRIDES = (1, 2, 2, 1)


@dataclass(frozen=True)
class SileroConfig:
    hidden: int = 128
    dtype: Any = torch.float32  # tiny model: float32 everywhere


class SileroState(NamedTuple):
    """Streaming carry: previous-chunk context + LSTM state. Shapes (B, ...)."""

    context: torch.Tensor  # (B, CONTEXT)
    h: torch.Tensor  # (B, hidden)
    c: torch.Tensor  # (B, hidden)

    @staticmethod
    def create(batch: int, cfg: SileroConfig = SileroConfig(), device: torch.device | str = "cpu") -> "SileroState":
        return SileroState(
            torch.zeros((batch, CONTEXT), dtype=cfg.dtype, device=device),
            torch.zeros((batch, cfg.hidden), dtype=cfg.dtype, device=device),
            torch.zeros((batch, cfg.hidden), dtype=cfg.dtype, device=device),
        )


def _stft_basis() -> np.ndarray:
    """(N, bins*2) real/imag DFT basis, hann-windowed."""
    n = np.arange(_STFT_N)
    k = np.arange(_N_BINS)
    ang = -2 * np.pi * np.outer(n, k) / _STFT_N
    win = np.hanning(_STFT_N + 1)[:-1]
    return np.concatenate([np.cos(ang) * win[:, None], np.sin(ang) * win[:, None]], axis=1).astype(
        np.float32
    )


@functools.lru_cache(maxsize=8)
def _basis(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_stft_basis()).to(device)


def init_params(cfg: SileroConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init weights drawn from *gen* on *device*: the JAX package's
    distributions, not its numbers."""
    dt, h = cfg.dtype, cfg.hidden
    convs = [{"w": normal(gen, (co, ci, 3), (3 * ci) ** -0.5, dt, device),
              "b": torch.zeros((co,), dtype=dt, device=device)} for ci, co in _CONV_DIMS]
    return {
        "convs": convs,
        "lstm": {
            "wi": normal(gen, (128, 4 * h), 128 ** -0.5, dt, device),
            "wh": normal(gen, (h, 4 * h), h ** -0.5, dt, device),
            "b": torch.zeros((4 * h,), dtype=dt, device=device),
        },
        "head": {
            "w": torch.full((h, 1), h ** -0.5, dtype=dt, device=device),
            "b": torch.zeros((1,), dtype=dt, device=device),
        },
    }


def _conv3(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """k=3, padding 1 convolution of h (B, T, C_in) in time-major layout as
    one product: w (C_out, C_in, 3) against each 3-tap window."""
    windows = torch.nn.functional.pad(h, (0, 0, 1, 1)).unfold(1, 3, stride)  # (B, T_out, C_in, 3)
    return windows.flatten(2) @ w.flatten(1).T + b


def step(params: Params, state: SileroState, chunk: torch.Tensor) -> tuple[torch.Tensor, SileroState]:
    """One 512-sample step. chunk: (B, 512) float32 in [-1, 1].
    Returns (prob (B,), new state)."""
    x = torch.cat([state.context, chunk], dim=1)  # (B, 576)
    new_context = chunk[:, -CONTEXT:]

    frames = x.unfold(1, _STFT_N, _STFT_HOP)  # (B, 3, 256)
    spec = frames @ _basis(x.device)
    re, im = spec[..., :_N_BINS], spec[..., _N_BINS:]
    h = torch.sqrt(re * re + im * im + 1e-12)  # (B, T, 129)

    for conv, s in zip(params["convs"], _CONV_STRIDES):
        h = torch.relu(_conv3(h, conv["w"], conv["b"], s))
    feat = h.mean(dim=1)  # (B, 128) pooled over time

    lstm = params["lstm"]
    gates = feat @ lstm["wi"] + state.h @ lstm["wh"] + lstm["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * state.c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(c)

    logit = new_h @ params["head"]["w"] + params["head"]["b"]
    prob = torch.sigmoid(logit)[:, 0]
    return prob, SileroState(new_context, new_h, c)


def scan_steps(params: Params, state: SileroState, chunks: torch.Tensor) -> tuple[torch.Tensor, SileroState]:
    """N sequential steps. chunks: (N, B, CHUNK).  Returns (probs (N, B),
    final state)."""
    probs = []
    for chunk in chunks:
        prob, state = step(params, state, chunk)
        probs.append(prob)
    return torch.stack(probs), state


class SileroVAD:
    """Stateful wrapper with the ``model(x, sr) -> prob`` calling convention
    the VAD iterator expects (single session, batch=1), on *device*."""

    def __init__(self, params: Params | None = None, seed: int = 0, device: torch.device | str = "cpu") -> None:
        self.device = torch.device(device)
        self.params = params if params is not None else init_params(
            SileroConfig(), torch.Generator(device=self.device).manual_seed(seed), self.device)
        self.state = SileroState.create(1, device=self.device)

    def __call__(self, chunk: np.ndarray, sr: int = SR) -> float:
        if sr != SR:
            raise ValueError(f"SileroVAD supports {SR} Hz, got {sr}")
        x = torch.from_numpy(np.asarray(chunk, dtype=np.float32).reshape(1, -1)).to(self.device)
        prob, self.state = step(self.params, self.state, x)
        return float(prob[0])

    def reset_states(self) -> None:
        self.state = SileroState.create(1, device=self.device)


def convert_silero_state_dict(sd: dict[str, Any], device: torch.device | str = "cpu") -> Params:
    """Map the silero-vad v5 jit ``state_dict`` (numpy arrays or tensors)
    onto the JAX package's tree on *device*.

    Torch conv weights are (out, in, k) -> (k, in, out); LSTMCell
    weight_ih (4h, in) -> (in, 4h) with torch gate order i,f,g,o preserved.
    Key names follow the published silero_vad.jit module tree
    (``_model.stft`` is replaced by the fixed DFT basis).
    """
    sd = HostStateDict(sd)
    convs = []
    for name in ["_model.encoder.0", "_model.encoder.1", "_model.encoder.2", "_model.encoder.3"]:
        w = sd[f"{name}.reparam_conv.weight"]
        convs.append({"w": w.transpose(2, 1, 0), "b": sd[f"{name}.reparam_conv.bias"]})
    wi = sd["_model.decoder.rnn.weight_ih"]
    wh = sd["_model.decoder.rnn.weight_hh"]
    b = sd["_model.decoder.rnn.bias_ih"] + sd["_model.decoder.rnn.bias_hh"]
    head_w = sd["_model.decoder.decoder.2.weight"]  # (1, 128, 1)
    return tree_to_device({
        "convs": convs,
        "lstm": {"wi": wi.T, "wh": wh.T, "b": b},
        "head": {"w": head_w.reshape(1, -1).T, "b": sd["_model.decoder.decoder.2.bias"]},
    }, device)
