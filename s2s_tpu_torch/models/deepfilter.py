"""DeepFilterNet-method speech enhancement in PyTorch, the port of
``s2s_tpu/models/deepfilter.py`` (reference ``VAD/vad_handler.py:44-50,
799-821``: the optional noise suppressor applied to VAD-final audio before
STT).

The same method, tree and numerics (f32, complex64 spectra) as the JAX
package (Schröter et al., DeepFilterNet / DeepFilterNet2):

1. **ERB gain stage** — log-power features in ERB-spaced bands with an
   exponential-decay mean normalisation drive a conv + GRU encoder/decoder
   that predicts per-band sigmoid gains, expanded back to the linear
   frequency axis and applied to the whole spectrum.
2. **Deep-filtering stage** — unit-normalised complex features of the
   lowest ``df_bins`` bins drive a decoder that predicts a complex FIR of
   ``df_order`` taps per bin over the noisy spectrum's history; its output
   replaces the low bins of the gained spectrum.

The JAX package scans :func:`frame_step` over the frames.  Here
:func:`filter_frames` takes a run of frames and an explicit
:class:`DFState`: only the two true recurrences loop over frames on the
device (the running means of the features, then the GRU); the features,
the causal (2, 3) convolutions (products over their windows, so cuDNN's
TF32 default never touches them), the embedding, both heads and the deep
filter are one product each over all frames.  A run split anywhere gives
the frames of one run: the state carries each recurrence and each
convolution's previous frame.  The STFT is a product with the DFT basis;
the output goes through :func:`s2s_tpu_torch.ops.istft.istft` with its
magnitude and angle, as in the JAX package.

Layouts: the JAX package's tree unchanged (the convolution weights stay
``(kT, kF, Cin, Cout)``), :func:`s2s_tpu_torch.weights.deepfilter_params`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from s2s_tpu_torch import weights
from s2s_tpu_torch.models.common import Params
from s2s_tpu_torch.models.decoder_lm import normal
from s2s_tpu_torch.ops.istft import istft


@dataclass(frozen=True)
class DeepFilterConfig:
    sample_rate: int = 16_000
    n_fft: int = 320          # 20 ms
    hop: int = 160            # 10 ms
    erb_bands: int = 32
    df_bins: int = 96         # deep-filtered low bins (<= n_fft // 2 + 1)
    df_order: int = 5
    conv_ch: int = 16
    emb_dim: int = 128
    norm_tau_s: float = 1.0
    min_db: float = -80.0

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def norm_alpha(self) -> float:
        return math.exp(-self.hop / (self.sample_rate * self.norm_tau_s))

    @staticmethod
    def dfn48k() -> "DeepFilterConfig":
        """Upstream DeepFilterNet rates (48 kHz, 960/480 STFT)."""
        return DeepFilterConfig(sample_rate=48_000, n_fft=960, hop=480,
                                conv_ch=64, emb_dim=256)

    @staticmethod
    def tiny() -> "DeepFilterConfig":
        return DeepFilterConfig(n_fft=64, hop=32, erb_bands=8, df_bins=16,
                                df_order=3, conv_ch=4, emb_dim=16)


def erb_filterbank(cfg: DeepFilterConfig) -> np.ndarray:
    """(erb_bands, n_bins) triangular filters on the ERB-rate scale."""
    def hz_to_erb(f):
        return 21.4 * np.log10(1 + 0.00437 * f)

    def erb_to_hz(e):
        return (10 ** (e / 21.4) - 1) / 0.00437

    nyq = cfg.sample_rate / 2
    pts = erb_to_hz(np.linspace(hz_to_erb(0), hz_to_erb(nyq), cfg.erb_bands + 2))
    bins = np.linspace(0, nyq, cfg.n_bins)
    fb = np.zeros((cfg.erb_bands, cfg.n_bins), np.float32)
    for b in range(cfg.erb_bands):
        lo, mid, hi = pts[b], pts[b + 1], pts[b + 2]
        up = (bins - lo) / max(mid - lo, 1e-9)
        down = (hi - bins) / max(hi - mid, 1e-9)
        fb[b] = np.clip(np.minimum(up, down), 0, 1)
    fb /= np.maximum(fb.sum(axis=1, keepdims=True), 1e-9)  # row-normalised
    return fb


def init_params(cfg: DeepFilterConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init weights drawn from *gen* on *device*: the JAX package's
    distributions and tree (also the JAX package's layout), not its numbers."""
    c, f32 = cfg.conv_ch, torch.float32

    def rnd(shape, scale=0.02):
        return normal(gen, shape, scale, f32, device)

    def zeros(n):
        return torch.zeros((n,), dtype=f32, device=device)

    def lin(di, do):
        return {"w": rnd((di, do), di ** -0.5), "b": zeros(do)}

    def conv(cin):
        return {"w": rnd((2, 3, cin, c)), "b": zeros(c)}

    e = cfg.emb_dim
    return weights.deepfilter_params({
        "erb_fb": erb_filterbank(cfg),
        # encoder convs: kernel (2 time, 3 freq), freq stride 2 on layer 1
        "erb_conv0": conv(1), "erb_conv1": conv(c), "df_conv0": conv(2), "df_conv1": conv(c),
        "emb_in": lin(c * (cfg.erb_bands // 2) + c * (cfg.df_bins // 2), e),
        "gru": {"wi": rnd((e, 3 * e), e ** -0.5), "wh": rnd((e, 3 * e), e ** -0.5),
                "bi": zeros(3 * e), "bh": zeros(3 * e)},
        "erb_dec": lin(e, cfg.erb_bands),
        "df_dec": lin(e, 2 * cfg.df_order * cfg.df_bins),
    }, device)


class DFState(NamedTuple):
    gru_h: torch.Tensor         # (emb_dim,)
    erb_mean: torch.Tensor      # (erb_bands,) feature-norm running mean (dB)
    mag_mean: torch.Tensor      # () unit-norm running magnitude
    erb_prev: torch.Tensor      # (erb_bands, 1) previous frame for conv t-kernel
    erb_prev1: torch.Tensor     # (erb_bands, ch) previous post-conv0 frame
    df_prev: torch.Tensor       # (df_bins, 2)
    df_prev1: torch.Tensor      # (df_bins, ch)
    spec_hist: torch.Tensor     # (df_order, df_bins) complex spectrum history


def init_state(cfg: DeepFilterConfig, device: torch.device | str = "cpu") -> DFState:
    c, f32 = cfg.conv_ch, torch.float32
    return DFState(
        gru_h=torch.zeros((cfg.emb_dim,), dtype=f32, device=device),
        erb_mean=torch.full((cfg.erb_bands,), -60.0, dtype=f32, device=device),
        mag_mean=torch.tensor(1e-4, dtype=f32, device=device),
        erb_prev=torch.zeros((cfg.erb_bands, 1), dtype=f32, device=device),
        erb_prev1=torch.zeros((cfg.erb_bands, c), dtype=f32, device=device),
        df_prev=torch.zeros((cfg.df_bins, 2), dtype=f32, device=device),
        df_prev1=torch.zeros((cfg.df_bins, c), dtype=f32, device=device),
        spec_hist=torch.zeros((cfg.df_order, cfg.df_bins), dtype=torch.complex64, device=device),
    )


def _causal_conv2d(prev, x, p, stride_f: int = 1):
    """The causal (2 time, 3 freq) convolution of every frame with the frame
    before it, freq padding 1, freq stride *stride_f*, then ReLU, as one
    product over the windows.  prev (F, Cin) is the frame before x's first;
    x (T, F, Cin).  Returns (T, F', Cout)."""
    seq = F.pad(torch.cat([prev[None], x]), (0, 0, 1, 1))  # (T+1, F+2, Cin)
    windows = seq.unfold(0, 2, 1).unfold(1, 3, stride_f)  # (T, F', Cin, 2, 3)
    t, f_out, cin = windows.shape[:3]
    w = p["w"].reshape(6 * cin, -1)  # (kT, kF, Cin) flattened in that order
    out = windows.permute(0, 1, 3, 4, 2).reshape(t, f_out, 6 * cin) @ w
    return torch.relu(out + p["b"])


def _recur_means(alpha: float, x: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """m_t = alpha * m_{t-1} + (1 - alpha) * x_t over the frames of x (T, n),
    from m_{-1} = init: (T, n)."""
    fresh = (1 - alpha) * x
    m, out = init, []
    for t in range(x.shape[0]):
        m = alpha * m + fresh[t]
        out.append(m)
    return torch.stack(out)


def _gru(p, emb: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """torch GRUCell semantics (reset gate on the hidden projection) over
    the frames of emb (T, E) from h: the hidden states (T, H)."""
    gi = emb @ p["wi"] + p["bi"]
    ir, iz, in_ = gi.chunk(3, dim=-1)
    out = []
    for t in range(emb.shape[0]):
        hr, hz, hn = (h @ p["wh"] + p["bh"]).chunk(3, dim=-1)
        r = torch.sigmoid(ir[t] + hr)
        z = torch.sigmoid(iz[t] + hz)
        n = torch.tanh(in_[t] + r * hn)
        h = (1 - z) * n + z * h
        out.append(h)
    return torch.stack(out)


def filter_frames(params: Params, cfg: DeepFilterConfig, spec: torch.Tensor, state: DFState):
    """Enhance a run of complex STFT frames (T, n_bins) from *state*.
    Returns (Y (T, n_bins), the state after the run's last frame)."""
    alpha, nb, order = cfg.norm_alpha, cfg.df_bins, cfg.df_order
    power = torch.square(torch.abs(spec))
    erb_db = torch.clamp(10.0 * torch.log10(power @ params["erb_fb"].T + 1e-10), min=cfg.min_db)
    mag = torch.sqrt(torch.mean(power[:, :nb], dim=-1) + 1e-10)
    means = _recur_means(alpha, torch.cat([erb_db, mag[:, None]], dim=1),
                         torch.cat([state.erb_mean, state.mag_mean[None]]))
    erb_mean, mag_mean = means[:, :-1], means[:, -1]
    erb_in = ((erb_db - erb_mean) / 40.0)[..., None]  # (T, erb, 1)
    df_c = spec[:, :nb] / (mag_mean[:, None] + 1e-10)
    df_in = torch.stack([df_c.real, df_c.imag], dim=-1)  # (T, df_bins, 2)

    # encoder (causal in time: the frame before the run carried in state)
    e0 = _causal_conv2d(state.erb_prev, erb_in, params["erb_conv0"])
    e1 = _causal_conv2d(state.erb_prev1, e0, params["erb_conv1"], stride_f=2)
    d0 = _causal_conv2d(state.df_prev, df_in, params["df_conv0"])
    d1 = _causal_conv2d(state.df_prev1, d0, params["df_conv1"], stride_f=2)

    t = spec.shape[0]
    flat = torch.cat([e1.reshape(t, -1), d1.reshape(t, -1)], dim=1)
    emb = torch.tanh(flat @ params["emb_in"]["w"] + params["emb_in"]["b"])
    h = _gru(params["gru"], emb, state.gru_h)

    gains = torch.sigmoid(h @ params["erb_dec"]["w"] + params["erb_dec"]["b"])
    coefs = (h @ params["df_dec"]["w"] + params["df_dec"]["b"]).reshape(t, order, nb, 2)
    coefs_c = torch.complex(coefs[..., 0], coefs[..., 1])

    # stage 1: ERB gains expanded to the linear axis (transpose filterbank)
    fb = params["erb_fb"]
    y = spec * (gains @ fb / torch.clamp(torch.sum(fb, dim=0), min=1e-9))

    # stage 2: deep filtering over the noisy-spectrum history (newest last;
    # only the filtered low bins are carried)
    seq = torch.cat([state.spec_hist[1:], spec[:, :nb]])  # (order - 1 + T, df_bins)
    hist = torch.stack([seq[k: k + t] for k in range(order)], dim=1)  # (T, order, df_bins)
    y = torch.cat([torch.sum(coefs_c * hist, dim=1), y[:, nb:]], dim=1)

    new_state = DFState(
        gru_h=h[-1], erb_mean=erb_mean[-1], mag_mean=mag_mean[-1],
        erb_prev=erb_in[-1], erb_prev1=e0[-1], df_prev=df_in[-1], df_prev1=d0[-1],
        spec_hist=seq[-order:],
    )
    return y, new_state


def _stft(cfg: DeepFilterConfig, audio: torch.Tensor) -> torch.Tensor:
    """(n,) f32 -> (T, n_bins) complex64: zero-padded n_fft//2 each side,
    periodic Hann, the DFT as a product with its real and imaginary bases."""
    n = cfg.n_fft
    window = torch.from_numpy(np.hanning(n + 1)[:-1].astype(np.float32)).to(audio.device)
    frames = F.pad(audio, (n // 2, n // 2)).unfold(0, n, cfg.hop) * window
    basis = np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(cfg.n_bins)) / n).astype(np.complex64)
    re, im = (torch.from_numpy(np.ascontiguousarray(part)).to(audio.device) for part in (basis.real, basis.imag))
    return torch.complex(frames @ re, frames @ im)


@torch.inference_mode()
def enhance(params: Params, cfg: DeepFilterConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio (n,) float32 at cfg.sample_rate -> enhanced audio, same length."""
    out, _ = filter_frames(params, cfg, _stft(cfg, audio), init_state(cfg, audio.device))
    audio_out = istft(torch.abs(out), torch.angle(out), cfg.n_fft, cfg.hop)
    return audio_out[: audio.shape[0]].float()


class DeepFilterEnhancer:
    """Host wrapper matching the VAD handler's ``enhancer`` hook: float32
    16 kHz in -> float32 out, the same length; the audio is padded to
    duration buckets as in the JAX package and enhanced on *device*."""

    BUCKETS = (16000, 32000, 48000, 80000, 128000, 240000, 480000)

    def __init__(self, params: Params | None = None, cfg: DeepFilterConfig = DeepFilterConfig(), seed: int = 0,
                 device: torch.device | str = "cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = params if params is not None else init_params(
            cfg, torch.Generator(device=self.device).manual_seed(seed), self.device)

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        audio = np.asarray(audio, np.float32)
        n = len(audio)
        if n == 0:
            return audio
        hop = self.cfg.hop
        bucket = next((b for b in self.BUCKETS if b >= n), None)
        if bucket is None:
            # beyond the largest bucket: pad to a hop multiple so the iSTFT
            # covers the full input (same-length contract of the hook)
            bucket = -(-n // hop) * hop
        padded = torch.from_numpy(np.pad(audio, (0, bucket - n))).to(self.device)
        out = enhance(self.params, self.cfg, padded).cpu().numpy()
        if len(out) < n:
            out = np.pad(out, (0, n - len(out)))
        return out[:n]
