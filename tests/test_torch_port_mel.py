"""Parity: the port's log-mel (s2s_tpu_torch.ops.mel, ops.log_mel) against the
JAX package.

- ``frame_audio`` equals the JAX framing exactly (indexing only).
- The plain ``log_mel_spectrogram`` against ``s2s_tpu.ops.mel.log_mel_spectrogram``
  and ``s2s_tpu.ops.pallas_mel.log_mel_spectrogram_pallas(interpret=True)``
  at 80 and 128 mels and several lengths: atol 1e-4 on the log-mel output
  (both f32 with the matmul DFT in different sum orders; measured below
  2.2e-5 on these inputs, as far as either is from an f64 reference).
- The golden data of ``tests/data/mel_golden.npz`` (transformers'
  WhisperFeatureExtractor): the filterbank within 1e-6 and the log-mel
  within max 0.05 / mean 1e-3, the JAX package's own bounds (f32 matmul DFT
  against the oracle's f64 FFT).
- The kernel wrapper routes CPU tensors to the plain version without a
  launch and checks what the kernel takes; the filterbank bands the kernel's
  mel projection sums over hold every nonzero weight, so the banded sum is
  the dense one bit for bit; the CUDA kernel itself runs only on the card
  (``cuda`` marker).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.ops import mel as jax_mel  # noqa: E402
from s2s_tpu.ops.pallas_mel import log_mel_spectrogram_pallas  # noqa: E402
from s2s_tpu_torch.ops import log_mel  # noqa: E402
from s2s_tpu_torch.ops import mel  # noqa: E402

ATOL = 1e-4


def _speech_like(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    tone = 0.3 * np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (0.1 * rng.standard_normal(n) + tone).astype(np.float32)


def test_frame_audio_equals_the_jax_framing():
    audio = _speech_like(4_321)
    want = np.asarray(jax_mel.frame_audio(jnp.asarray(audio)))
    got = mel.frame_audio(torch.from_numpy(audio)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n", [4_000, 16_037, 48_000])
def test_plain_log_mel_matches_jax_and_the_interpreted_pallas_kernel(n, n_mels):
    audio = _speech_like(n, seed=n)
    got = mel.log_mel_spectrogram(torch.from_numpy(audio), n_mels).numpy()
    want = np.asarray(jax_mel.log_mel_spectrogram(audio, n_mels))
    pallas = np.asarray(log_mel_spectrogram_pallas(audio, n_mels, interpret=True))
    assert got.shape == want.shape == (n_mels, n // mel.HOP_LENGTH)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


def test_log_mel_matches_the_whisper_golden():
    golden = np.load(os.path.join(os.path.dirname(__file__), "data", "mel_golden.npz"))
    np.testing.assert_allclose(mel.mel_filter_bank(80), golden["fb80"], atol=1e-6)
    t = np.arange(16_000) / 16_000
    audio = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32) + 0.1 * np.random.RandomState(0).randn(
        16_000).astype(np.float32)
    padded = np.zeros(480_000, np.float32)
    padded[: len(audio)] = audio
    ours = mel.log_mel_spectrogram(torch.from_numpy(padded)).numpy()
    assert ours.shape == golden["ref_mel"].shape
    diff = np.abs(ours - golden["ref_mel"])
    assert diff.max() < 0.05 and diff.mean() < 1e-3


@pytest.mark.parametrize("n_mels", [80, 128])
def test_wrapper_routes_cpu_tensors_to_the_plain_version(n_mels):
    audio = torch.from_numpy(_speech_like(8_000))
    before = log_mel.mel_power.launches
    got = log_mel.log_mel_spectrogram(audio, n_mels)
    assert torch.equal(got, mel.log_mel_spectrogram(audio, n_mels))
    assert torch.equal(log_mel.mel_power(audio, n_mels), mel.mel_power(audio, n_mels))
    assert log_mel.mel_power.launches == before


def test_kernel_checks_reject_what_the_kernel_does_not_take():
    cos_b, sin_b, fb = mel.tables(80, torch.device("cpu"))
    audio = torch.from_numpy(_speech_like(1_600))
    log_mel._check(audio, cos_b, sin_b, fb, mel.N_FFT, mel.HOP_LENGTH)  # the supported case passes
    with pytest.raises(ValueError, match="f32 audio"):
        log_mel._check(audio.double(), cos_b, sin_b, fb, mel.N_FFT, mel.HOP_LENGTH)
    with pytest.raises(ValueError, match="do not match"):
        log_mel._check(audio, cos_b[:, :100], sin_b, fb, mel.N_FFT, mel.HOP_LENGTH)
    with pytest.raises(ValueError, match="does not support"):
        big = torch.zeros(600, 301)
        log_mel._check(audio, big, big, torch.zeros(301, 80), 600, mel.HOP_LENGTH)
    with pytest.raises(ValueError, match="multiple of 4"):
        log_mel._check(audio, cos_b, sin_b, fb, mel.N_FFT, 162)
    with pytest.raises(ValueError, match="more than"):
        log_mel._check(audio[:150], cos_b, sin_b, fb, mel.N_FFT, mel.HOP_LENGTH)
    with pytest.raises(ValueError, match="device"):
        log_mel.mel_power(audio.to("meta"))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_bands_hold_every_nonzero_filterbank_weight(n_mels):
    fb = mel.mel_filter_bank(n_mels)
    band = log_mel.bands(n_mels, torch.device("cpu")).numpy()
    assert band.shape == (n_mels, 2) and band.dtype == np.int32
    rows = np.arange(fb.shape[0])[:, None]
    inside = (rows >= band[:, 0]) & (rows < band[:, 1])
    cols = np.arange(n_mels)
    assert np.all(fb[~inside] == 0)
    assert np.all(fb[band[:, 0], cols] != 0) and np.all(fb[band[:, 1] - 1, cols] != 0)
    # the kernel's projection sums each mel over its band in row order; the
    # terms it skips are exact zeros, so it equals the dense sum bit for bit
    power = np.random.default_rng(n_mels).exponential(size=(16, fb.shape[0])).astype(np.float32)
    dense = np.zeros((16, n_mels), np.float32)
    for k in range(fb.shape[0]):
        dense = dense + power[:, k : k + 1] * fb[k]
    banded = np.zeros_like(dense)
    for m, (lo, hi) in enumerate(band):
        for k in range(lo, hi):
            banded[:, m] = banded[:, m] + power[:, k] * fb[k, m]
    np.testing.assert_array_equal(banded, dense)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seconds,n_mels", [(1, 80), (8, 80), (30, 128)])
def test_cuda_kernel_matches_plain(cuda_device, seconds, n_mels):
    """Kernel against the plain torch ops on the card, TF32 off, at the
    chip_smoke atol of 5e-4 on the log-mel output."""
    audio = torch.from_numpy(_speech_like(seconds * 16_000)).to(cuda_device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = log_mel.mel_power.launches
        got = log_mel.log_mel_spectrogram(audio, n_mels)
        want = mel.log_mel_spectrogram(audio, n_mels)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert log_mel.mel_power.launches == before + 1
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 5e-4
