"""Parity: the port's log-mel (s2s_tpu_torch.ops.mel, ops.log_mel) against the
JAX package, and a model of the log-mel kernel's arithmetic.

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
- The kernel's FFT, modelled in numpy f32 (:func:`kernel_fft_power`: the
  same window and twiddle tables, the same radix sequence of Stockham
  stages with the same butterflies, the same real-FFT split), against
  ``np.fft.rfft`` in f64 for n_fft 400 (Whisper) and 512 (Parakeet): the
  power within 2e-6 x the frame's largest bin (f32 rounding through three
  stages and the split; measured below 5e-7).
- The launch plan at the served shapes with an H100's 132 SMs: every tile
  has a block, the grid fits the co-resident slots, the fewest frames a
  tile that fit.
- The kernel wrappers route CPU tensors to the plain versions without a
  launch and check what the kernel takes (257 bins accepted; wrong type,
  device and rank refused); the filterbank bands the kernel's mel
  projection sums over hold every nonzero weight, so the banded sum is the
  dense one bit for bit; the CUDA kernel itself runs only on the card
  (``cuda`` marker), against the plain versions, run twice bit-equal.
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
    before = log_mel.log_mel_spectrogram.launches, log_mel.parakeet_log_mel.launches
    got = log_mel.log_mel_spectrogram(audio, n_mels)
    assert torch.equal(got, mel.log_mel_spectrogram(audio, n_mels))
    rows = torch.stack([audio, torch.zeros_like(audio)])
    n_valid = torch.tensor([7_000, 0], dtype=torch.int32)
    fe = log_mel.Frontend(n_mels=n_mels)
    feats, frames = log_mel.parakeet_log_mel(rows, n_valid, fe)
    want, want_frames = log_mel.parakeet_log_mel_reference(rows, n_valid, fe)
    assert torch.equal(feats, want) and torch.equal(frames, want_frames)
    assert (log_mel.log_mel_spectrogram.launches, log_mel.parakeet_log_mel.launches) == before


def test_kernel_checks_reject_what_the_kernel_does_not_take():
    audio = torch.from_numpy(_speech_like(1_600))
    rows = audio[None].repeat(2, 1)
    n_valid = torch.tensor([1_600, 800], dtype=torch.int32)
    log_mel.log_mel_spectrogram(audio, 128)  # the supported cases pass
    log_mel.parakeet_log_mel(rows, n_valid, log_mel.Frontend(n_mels=128, n_fft=512))  # 257 bins
    with pytest.raises(ValueError, match="f32 audio"):
        log_mel.log_mel_spectrogram(audio.double())
    with pytest.raises(ValueError, match="f32 audio"):
        log_mel.log_mel_spectrogram(rows)  # rank
    with pytest.raises(ValueError, match="f32 audio"):
        log_mel.log_mel_spectrogram(rows[:, ::2][0])  # layout
    with pytest.raises(ValueError, match="f32 audio"):
        log_mel.parakeet_log_mel(audio, n_valid[:1])  # rank
    with pytest.raises(ValueError, match="int32 n_valid"):
        log_mel.parakeet_log_mel(rows, n_valid.long())
    with pytest.raises(ValueError, match="int32 n_valid"):
        log_mel.parakeet_log_mel(rows, n_valid[:1])
    with pytest.raises(ValueError, match="does not support"):
        log_mel.parakeet_log_mel(rows, n_valid, log_mel.Frontend(n_fft=1024))  # 513 bins
    with pytest.raises(ValueError, match="not a product"):
        log_mel.parakeet_log_mel(rows, n_valid, log_mel.Frontend(n_fft=420))
    with pytest.raises(ValueError, match="more than"):
        log_mel.log_mel_spectrogram(audio[:150])
    with pytest.raises(ValueError, match="device"):
        log_mel.log_mel_spectrogram(audio.to("meta"))
    with pytest.raises(ValueError, match="device"):
        log_mel.parakeet_log_mel(rows.to("meta"), n_valid)


def kernel_fft_power(frames: np.ndarray, window: np.ndarray) -> np.ndarray:
    """A numpy f32 model of the kernel's per-frame arithmetic: (F, n_fft)
    frames -> (F, n_fft / 2 + 1) power.  The window from its table, each
    frame packed as n_fft / 2 complex points, the Stockham stages of
    ``fft_radices`` with the kernel's butterflies (their constants from the
    twiddle table), then the real-FFT split."""
    n_fft = frames.shape[1]
    m = n_fft // 2
    tw = log_mel.twiddles(n_fft)
    twc = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    xw = frames.astype(np.float32) * window
    src = (xw[:, 0::2] + 1j * xw[:, 1::2]).astype(np.complex64)
    ns = 1
    for r in log_mel.fft_radices(m):
        per, step = m // r, n_fft // (ns * r)
        j = np.arange(per)
        k = j % ns
        v = [src[:, j + q * per] * (twc[q * k * step] if q else np.complex64(1)) for q in range(r)]
        if r == 2:
            out = [v[0] + v[1], v[0] - v[1]]
        elif r == 4:
            out = _dft4(*v)
        elif r == 8:
            e, o = _dft4(v[0], v[2], v[4], v[6]), _dft4(v[1], v[3], v[5], v[7])
            h = np.float32(tw[n_fft // 8, 0])
            o = [o[0], h * (o[1].real + o[1].imag) + 1j * (h * (o[1].imag - o[1].real)), -1j * o[2],
                 h * (o[3].imag - o[3].real) - 1j * (h * (o[3].real + o[3].imag))]
            out = [e[q] + o[q] for q in range(4)] + [e[q] - o[q] for q in range(4)]
        else:
            c1, s1 = tw[n_fft // 5, 0], -tw[n_fft // 5, 1]
            c2, s2 = tw[2 * n_fft // 5, 0], -tw[2 * n_fft // 5, 1]
            a1, d1, a2, d2 = v[1] + v[4], v[1] - v[4], v[2] + v[3], v[2] - v[3]
            r1, i1 = v[0] + c1 * a1 + c2 * a2, -1j * (s1 * d1 + s2 * d2)
            r2, i2 = v[0] + c2 * a1 + c1 * a2, -1j * (s2 * d1 - s1 * d2)
            out = [v[0] + (a1 + a2), r1 + i1, r2 + i2, r2 - i2, r1 - i1]
        dst = np.empty_like(src)
        for q in range(r):
            dst[:, (j // ns) * ns * r + k + q * ns] = out[q].astype(np.complex64)
        src, ns = dst, ns * r
    k = np.arange(m)
    za, zb = src[:, k], src[:, (m - k) % m]
    e = np.float32(0.5) * (za.real + zb.real) + 1j * (np.float32(0.5) * (za.imag - zb.imag))
    o = np.float32(0.5) * (za.imag + zb.imag) + 1j * (np.float32(0.5) * (zb.real - za.real))
    x = (e + twc[k] * o).astype(np.complex64)
    power = (x.real * x.real + x.imag * x.imag).astype(np.float32)
    nyquist = (src[:, 0].real - src[:, 0].imag) ** 2
    return np.concatenate([power, nyquist[:, None].astype(np.float32)], axis=1)


def _dft4(v0, v1, v2, v3):
    t0, t1, t2, t3 = v0 + v2, v0 - v2, v1 + v3, -1j * (v1 - v3)
    return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]


@pytest.mark.parametrize("n_fft", [400, 512])
def test_kernel_fft_model_matches_numpy_rfft(n_fft):
    """The kernel's FFT plan in f32 against an f64 FFT: the power within
    2e-6 x each frame's largest bin, on speech-like frames and noise."""
    window = log_mel.whisper_window() if n_fft == 400 else mel.centred_window(512, 400).astype(np.float32)
    rng = np.random.default_rng(n_fft)
    frames = np.concatenate([_speech_like(40 * n_fft, seed=n_fft).reshape(40, n_fft),
                             rng.standard_normal((8, n_fft)).astype(np.float32)])
    got = kernel_fft_power(frames, window)
    want = np.abs(np.fft.rfft(frames.astype(np.float64) * window.astype(np.float64))) ** 2
    assert got.shape == want.shape == (48, n_fft // 2 + 1)
    err = np.abs(got - want).max(axis=1) / want.max(axis=1)
    assert err.max() < 2e-6, err.max()


def test_fft_radices_and_their_packing():
    assert log_mel.fft_radices(200) == (8, 5, 5)
    assert log_mel.fft_radices(256) == (8, 8, 4)
    assert log_mel.pack_radices((8, 5, 5)) == 8 | 5 << 4 | 5 << 8
    with pytest.raises(ValueError, match="not a product"):
        log_mel.fft_radices(210)


def _h100_occupancy(smem_per_sm=233_472, optin=232_448):
    """An H100-like occupancy model for the plan: a block of up to 256
    threads, 8 a SM by threads and registers, the rest by shared memory
    (each block also reserves 1 KB); shared memory as the kernel's layout."""

    def occupancy(ff, tpb, cache, n_fft=512, hop=160, n_mels=128, n_wts=514, parakeet=True):
        def up4(x):
            return (x + 3) & ~3
        floats = (2 * n_fft + up4(n_fft) + up4(n_wts) + up4(3 * n_mels) + up4((ff - 1) * hop + n_fft)
                  + 2 * up4(ff * n_fft) + 256 + (up4(2 * n_mels) if parakeet else 0)
                  + (up4(tpb * ff * n_mels) if cache else 0))
        smem = 4 * floats
        return (min(8, smem_per_sm // (smem + 1024)) if smem <= optin else 0), smem

    return occupancy


@pytest.mark.parametrize("rows,seconds,max_tiles_per_row", [
    (1, 1, None), (1, 8, None), (1, 30, None), (1, 1, 32), (4, 3, 32), (16, 15, 32), (16, 30, 32), (1, 30, 32)])
def test_launch_plan_gives_every_tile_a_resident_block(rows, seconds, max_tiles_per_row):
    """Whisper's plans (no bound on a row's tiles) and Parakeet's."""
    n_frames = 1 + seconds * 100
    occupancy = _h100_occupancy()
    plan = log_mel.launch_plan(rows, n_frames, 132, occupancy, max_tiles_per_row=max_tiles_per_row)
    tiles = rows * plan.tiles_per_row
    assert plan.tiles_per_row * plan.frames_per_tile >= n_frames
    assert plan.grid * plan.tiles_per_block >= tiles > (plan.grid - 1) * plan.tiles_per_block
    assert plan.grid <= plan.blocks_per_sm * 132
    assert (plan.blocks_per_sm, plan.smem) == occupancy(plan.frames_per_tile, plan.tiles_per_block, plan.cache)
    smaller = [ff for ff in log_mel.FRAMES_PER_TILE if ff < plan.frames_per_tile]
    for ff in smaller:  # a smaller tile would not have given every tile its own block in a short row
        per_row = -(-n_frames // ff)
        per_sm = min(occupancy(ff, 1, False)[0], log_mel.TILE_BLOCKS_PER_SM)
        assert rows * per_row > per_sm * 132 or per_row > (max_tiles_per_row or per_row)
    if max_tiles_per_row and plan.frames_per_tile < log_mel.FRAMES_PER_TILE[-1]:
        assert plan.tiles_per_row <= max_tiles_per_row
    if plan.tiles_per_block == 1:
        assert plan.grid == tiles


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
        before = log_mel.log_mel_spectrogram.launches
        got = log_mel.log_mel_spectrogram(audio, n_mels)
        want = mel.log_mel_spectrogram(audio, n_mels)
        again = log_mel.log_mel_spectrogram(audio, n_mels)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert log_mel.log_mel_spectrogram.launches == before + 2
    assert got.shape == want.shape and got.is_contiguous()
    assert (got - want).abs().max().item() <= 5e-4
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,seconds", [(1, 1), (4, 3), (16, 1)])
def test_cuda_parakeet_kernel_matches_plain(cuda_device, rows, seconds):
    """The batched Parakeet frontend through the kernel against the plain
    batched version on the card, TF32 off, within 1e-4 x max|plain| (the
    CPU parity bound); the padding row exactly zero; a second run
    bit-equal."""
    n = seconds * 16_000
    audio = np.stack([_speech_like(n, seed=i) for i in range(rows)])
    n_valid = np.array([n - (i * n) // (2 * rows) for i in range(rows)], np.int32)
    if rows > 1:
        n_valid[-1] = 0
    for i, nv in enumerate(n_valid):
        audio[i, nv:] = 0.0
    audio = torch.from_numpy(audio).to(cuda_device)
    n_valid = torch.from_numpy(n_valid).to(cuda_device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = log_mel.parakeet_log_mel.launches
        got, frames = log_mel.parakeet_log_mel(audio, n_valid)
        want, want_frames = log_mel.parakeet_log_mel_reference(audio, n_valid, log_mel.Frontend())
        again, _ = log_mel.parakeet_log_mel(audio, n_valid)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert log_mel.parakeet_log_mel.launches == before + 2
    assert got.shape == want.shape == (rows, 1 + n // 160, 128)
    assert torch.equal(frames, want_frames)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert torch.equal(got, again)
    if rows > 1:
        assert torch.count_nonzero(got[-1]).item() == 0
