"""Log-mel features in one kernel launch: Whisper's log-mel and Parakeet's
frontend.

The port of the TPU Pallas kernel ``s2s_tpu/ops/pallas_mel.py::log_mel_spectrogram_pallas``
and of the log steps around it, as a hand-written CUDA kernel for Hopper
(``csrc/log_mel.cu``, whose header says what bounds it and how the design
answers that): a cooperative launch of persistent blocks that frames the
audio, runs a mixed-radix FFT per frame (:func:`fft_radices`), takes the
power, sums each mel's band of nonzero filterbank weights (:func:`bands`),
takes the log and finishes with the steps that need the whole call (grid
barriers, no atomics).  Parakeet's frontend (XLA in the JAX package,
``s2s_tpu/models/parakeet.py::log_mel_frontend`` under ``vmap``) is the same
function with other parameters and rides on the same kernel, one launch per
batch.

- :func:`log_mel_spectrogram` (Whisper, Smart Turn, the voice-clone speaker)
  and :func:`parakeet_log_mel` (Parakeet, batched): a tensor on the CPU
  takes the plain PyTorch version (:func:`s2s_tpu_torch.ops.mel.log_mel_spectrogram`,
  :func:`parakeet_log_mel_reference`); a CUDA tensor launches the kernel or
  raises.  There is no fallback.
- ``log_mel_spectrogram.launches`` and ``parakeet_log_mel.launches`` count
  kernel launches.
- The twiddle and window tables are built here in f64 and rounded to f32;
  :func:`launch_plan` sizes the frame tiles and the grid from the card's
  occupancy.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from s2s_tpu_torch.ops import _build
from s2s_tpu_torch.ops import mel as mel_ref

#: one thread per complex point of a frame: n_fft / 2 <= 256, so up to 257
#: frequency bins (Parakeet's n_fft 512)
MAX_POINTS = 256
#: the FFT's radices, largest first (the kernel has butterflies for these)
RADICES = (8, 4, 2, 5)
#: frames a block tile may hold; the plan takes the fewest that give every
#: tile a block of its own at no more than TILE_BLOCKS_PER_SM blocks an SM
#: (the fastest choice at 1, 8 and 30 s on an H100: fewer frames a tile
#: means more blocks, each paying the table loads and the barriers)
FRAMES_PER_TILE = (1, 2, 4, 8)
TILE_BLOCKS_PER_SM = 2
#: Parakeet's row statistics: every block of a row sums the row's segment
#: partials, so their traffic grows with the square of the tiles a row; the
#: plan keeps a row to this many tiles where it can (the fewest frames a tile
#: that fit it measured fastest on an H100)
PARAKEET_MAX_TILES_PER_ROW = 32
LOG_ZERO_GUARD = 2.0 ** -24
NORM_EPS = 1e-5


@dataclass(frozen=True)
class Frontend:
    """Parakeet's frontend parameters (``ParakeetConfig``'s): preemphasis,
    a symmetric hann(win_length) centred in n_fft points, zero padding by
    n_fft // 2, hop, n_mels slaney mels over n_fft // 2 + 1 bins."""

    n_mels: int = 128
    n_fft: int = 512
    win_length: int = 400
    hop: int = 160
    preemphasis: float = 0.97
    sample_rate: int = 16_000


def fft_radices(points: int) -> tuple[int, ...]:
    """The kernel's Stockham plan for a complex FFT of *points*: radices 8,
    then 4, 2 and 5, first stage first (200 -> 8, 5, 5; 256 -> 8, 8, 4)."""
    out, rest = [], points
    for r in RADICES:
        while rest % r == 0:
            out.append(r)
            rest //= r
    if rest != 1 or points < 2:
        raise ValueError(f"log-mel FFT of {points} points: not a product of {RADICES}")
    return tuple(out)


def pack_radices(radices: tuple[int, ...]) -> int:
    """The radices as the kernel takes them: 4 bits each, first stage lowest."""
    return sum(r << (4 * i) for i, r in enumerate(radices))


def twiddles(n_fft: int) -> np.ndarray:
    """(n_fft, 2) f32: exp(-2 pi i k / n_fft), computed in f64.  The FFT of
    n_fft / 2 points takes its twiddles W^q as entries 2q; the real-FFT
    split takes entry k for bin k."""
    angle = -2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(angle), np.sin(angle)], axis=1).astype(np.float32)


def whisper_window() -> np.ndarray:
    """Whisper's periodic hann(400), f32 from f64."""
    return np.hanning(mel_ref.N_FFT + 1)[:-1].astype(np.float32)


@lru_cache(maxsize=16)
def bands(n_mels: int, device: torch.device, n_freqs: int = mel_ref.N_FREQS) -> torch.Tensor:
    """(n_mels, 2) int32 on *device*: the [first, last + 1) row of each mel's
    nonzero weights in the slaney filterbank of n_freqs bins
    (:func:`s2s_tpu_torch.ops.mel.mel_filter_bank`; (0, 0) for an all-zero
    column).  The triangles cover a few bins each and the filterbank is
    exactly zero elsewhere, so a sum over the band is the dense sequential
    sum, bit for bit."""
    nz = mel_ref.mel_filter_bank(n_mels, n_freqs) != 0
    any_nz = nz.any(axis=0)
    lo = np.where(any_nz, nz.argmax(axis=0), 0)
    hi = np.where(any_nz, nz.shape[0] - nz[::-1].argmax(axis=0), 0)
    return torch.from_numpy(np.stack([lo, hi], axis=1).astype(np.int32)).to(device)


@lru_cache(maxsize=16)
def band_table(n_mels: int, n_freqs: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's filterbank: ((n_mels, 3) int32 first row, end row and
    offset of each mel's band in the packed weights, (n_wts,) f32 the
    weights of every band, band after band), on *device*."""
    fb = mel_ref.mel_filter_bank(n_mels, n_freqs)
    band = bands(n_mels, torch.device("cpu"), n_freqs).numpy()
    widths = band[:, 1] - band[:, 0]
    offsets = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int32)
    wts = np.concatenate([fb[lo:hi, m] for m, (lo, hi) in enumerate(band)] + [np.zeros(0, np.float32)])
    table = np.concatenate([band, offsets[:, None]], axis=1).astype(np.int32)
    return torch.from_numpy(table).to(device), torch.from_numpy(wts.astype(np.float32)).to(device)


@lru_cache(maxsize=16)
def _tables(kind: str, n_fft: int, win_length: int, n_mels: int, device: torch.device):
    window = whisper_window() if kind == "whisper" else mel_ref.centred_window(n_fft, win_length).astype(np.float32)
    band, wts = band_table(n_mels, n_fft // 2 + 1, device)
    return torch.from_numpy(twiddles(n_fft)).to(device), torch.from_numpy(window).to(device), band, wts


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Plan:
    """How a call is cut: tiles of *frames_per_tile* frames of one row,
    *tiles_per_block* consecutive tiles a block, *grid* blocks all resident
    at once (*blocks_per_sm* a card's SM holds at *smem* bytes each); *cache*
    keeps the tiles' log-mel in shared memory across the grid barriers."""

    frames_per_tile: int
    tiles_per_row: int
    tiles_per_block: int
    grid: int
    cache: bool
    smem: int
    blocks_per_sm: int

    def describe(self) -> dict:
        return {"frames_per_tile": self.frames_per_tile, "tiles_per_block": self.tiles_per_block,
                "grid": self.grid, "cache": self.cache, "smem": self.smem, "blocks_per_sm": self.blocks_per_sm}


#: occupancy(frames_per_tile, tiles_per_block, cache) -> (blocks an SM
#: holds, shared memory of a block in bytes)
Occupancy = Callable[[int, int, bool], tuple[int, int]]


def launch_plan(rows: int, n_frames: int, sms: int, occupancy: Occupancy,
                max_tiles_per_row: int | None = None) -> Plan:
    """The fewest frames a tile (from :data:`FRAMES_PER_TILE`) such that
    every tile gets a block of its own at
    :data:`TILE_BLOCKS_PER_SM` blocks an SM and a row has at most
    *max_tiles_per_row* tiles, else the most; tiles then split evenly over
    at most as many blocks as the card holds at once; the log-mel stays in
    shared memory if the blocks still fit with it."""
    for ff in FRAMES_PER_TILE:
        per_sm, _ = occupancy(ff, 1, False)
        tiles_per_row = -(-n_frames // ff)
        tiles = rows * tiles_per_row
        if (tiles <= min(per_sm, TILE_BLOCKS_PER_SM) * sms
                and (max_tiles_per_row is None or tiles_per_row <= max_tiles_per_row)):
            break
    slots = per_sm * sms
    if slots < 1:
        raise RuntimeError(f"log-mel: no block of {ff} frames fits an SM")
    tiles_per_block = -(-tiles // slots)
    while tiles_per_block <= tiles:
        grid = -(-tiles // tiles_per_block)
        for cache in (True, False):
            per_sm, smem = occupancy(ff, tiles_per_block, cache)
            if per_sm * sms >= grid:
                return Plan(ff, tiles_per_row, tiles_per_block, grid, cache, smem, per_sm)
        tiles_per_block += 1
    raise RuntimeError(f"log-mel: {tiles} tiles of {ff} frames do not fit the card")


@lru_cache(maxsize=256)
def _device_plan(parakeet: bool, rows: int, n_frames: int, n_fft: int, hop: int, n_mels: int, n_wts: int,
                 index: int) -> Plan:
    lib = _build.load()

    def occupancy(ff: int, tpb: int, cache: bool) -> tuple[int, int]:
        smem = ctypes.c_int(0)
        with torch.cuda.device(index):
            blocks = lib.s2s_log_mel_blocks_per_sm(int(parakeet), n_fft, hop, n_mels, n_wts, ff, tpb, int(cache),
                                                   ctypes.byref(smem))
        if blocks < 0:
            raise RuntimeError(f"log-mel occupancy query failed: cudaError {-blocks}")
        return blocks, smem.value

    return launch_plan(rows, n_frames, torch.cuda.get_device_properties(index).multi_processor_count, occupancy,
                       PARAKEET_MAX_TILES_PER_ROW if parakeet else None)


def device_plan(parakeet: bool, rows: int, n: int, n_mels: int, device: torch.device, n_fft: int,
                hop: int = mel_ref.HOP_LENGTH) -> Plan:
    """The plan of a call on *device*: (rows, n) audio, Whisper's form
    (n // hop frames) or Parakeet's (1 + n // hop)."""
    n_frames = 1 + n // hop if parakeet else n // hop
    n_wts = band_table(n_mels, n_fft // 2 + 1, device)[1].numel()
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _device_plan(parakeet, rows, n_frames, n_fft, hop, n_mels, n_wts, index)


def _launch(parakeet: bool, audio: torch.Tensor, n_valid: torch.Tensor | None, out: torch.Tensor,
            frames_out: torch.Tensor | None, tables, n_fft: int, hop: int, n_mels: int, preemphasis: float,
            plan: Plan) -> None:
    tw, window, band, wts = tables
    rows, n = audio.shape
    n_frames = out.shape[1]
    tiles = rows * plan.tiles_per_row
    partial = torch.empty((2 * tiles * n_mels) if parakeet else plan.grid, dtype=torch.float32,
                          device=audio.device)
    with torch.cuda.device(audio.device):
        err = _build.load().s2s_log_mel(
            int(parakeet), audio.data_ptr(), n_valid.data_ptr() if parakeet else None, tw.data_ptr(),
            window.data_ptr(), band.data_ptr(), wts.data_ptr(), out.data_ptr(),
            frames_out.data_ptr() if parakeet else None, partial.data_ptr(), rows, n, n_frames, n_fft, hop,
            n_mels, wts.numel(), pack_radices(fft_radices(n_fft // 2)), plan.frames_per_tile,
            plan.tiles_per_row, plan.tiles_per_block, plan.grid, int(plan.cache), preemphasis,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"log-mel kernel launch failed: cudaError {err} (rows={rows}, N={n}, "
                           f"n_mels={n_mels}, plan={plan.describe()})")


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------


def _check_audio(audio: torch.Tensor, dim: int, what: str) -> None:
    if audio.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {audio.device}")
    if audio.dim() != dim or audio.dtype != torch.float32 or not audio.is_contiguous():
        raise ValueError(f"{what} wants contiguous {'(N,)' if dim == 1 else '(B, N)'} f32 audio; "
                         f"got {tuple(audio.shape)} {audio.dtype}")


def _check_mels(n_mels: int, n_fft: int) -> None:
    fft_radices(n_fft // 2)
    if n_fft // 2 > MAX_POINTS or n_fft // 2 < 32 or n_mels < 1 or n_mels > n_fft // 2:
        raise ValueError(f"log-mel does not support n_fft {n_fft} (up to {2 * MAX_POINTS}, "
                         f"{MAX_POINTS + 1} bins) with {n_mels} mels (at most n_fft / 2)")


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Whisper log-mel features (n_mels, N // hop) of *audio* (N,) f32 at
    16 kHz on its device: the same contract as the plain
    :func:`s2s_tpu_torch.ops.mel.log_mel_spectrogram`.  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/log_mel.cu`` once on the
    current stream (built at first use) and raise on any shape, type,
    layout or launch error."""
    _check_audio(audio, 1, "log-mel")
    _check_mels(n_mels, mel_ref.N_FFT)
    if audio.shape[0] <= mel_ref.N_FFT // 2:
        raise ValueError(f"log-mel needs more than n_fft // 2 = {mel_ref.N_FFT // 2} samples; "
                         f"got {audio.shape[0]}")
    if audio.device.type == "cpu":
        return mel_ref.log_mel_spectrogram(audio, n_mels)
    n, hop = audio.shape[0], mel_ref.HOP_LENGTH
    plan = device_plan(False, 1, n, n_mels, audio.device, mel_ref.N_FFT)
    out = torch.empty((n_mels, n // hop), dtype=torch.float32, device=audio.device)
    _launch(False, audio[None], None, out, None, _tables("whisper", mel_ref.N_FFT, mel_ref.N_FFT, n_mels,
                                                         audio.device),
            mel_ref.N_FFT, hop, n_mels, 0.0, plan)
    _build.count_launch(log_mel_spectrogram)
    return out


log_mel_spectrogram.launches = 0


# ---------------------------------------------------------------------------
# Parakeet
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def stft_tables(fe: Frontend, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cos basis, sin basis, filterbank) of the plain frontend on *device*:
    the windowed real-DFT bases (n_fft, n_fft // 2 + 1) and the slaney
    filterbank (n_fft // 2 + 1, n_mels)."""
    cos_b, sin_b = mel_ref.stft_basis(fe.n_fft, fe.win_length)
    fb = mel_ref.mel_filter_bank(fe.n_mels, fe.n_fft // 2 + 1, fe.sample_rate)
    return tuple(torch.from_numpy(a).to(device) for a in (cos_b, sin_b, fb))


def parakeet_log_mel_reference(audio: torch.Tensor, n_valid: torch.Tensor,
                               fe: Frontend) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain batched Parakeet frontend: ``log_mel_frontend`` of
    ``s2s_tpu_torch.models.parakeet`` with the batch written out.  audio
    (B, N) f32, zero-padded past each row's n_valid (B,) -> ((B, 1 + N //
    hop, n_mels) features, (B,) valid frames n_valid // hop)."""
    b, n = audio.shape
    dev = audio.device
    x = torch.cat([audio[:, :1], audio[:, 1:] - fe.preemphasis * audio[:, :-1]], dim=1)
    n_valid = n_valid.to(device=dev, dtype=torch.int64)
    x = torch.where(torch.arange(n, device=dev)[None, :] < n_valid[:, None], x, 0.0).float()
    pad = fe.n_fft // 2
    x = F.pad(x, (pad, pad))
    n_frames = 1 + n // fe.hop
    frames = x.unfold(1, fe.n_fft, fe.hop)[:, :n_frames]  # (B, T, n_fft)
    cos_b, sin_b, fb = stft_tables(fe, dev)
    re = frames @ cos_b
    im = frames @ sin_b
    mel = (re * re + im * im) @ fb
    logmel = torch.log(mel + LOG_ZERO_GUARD)
    valid = torch.div(n_valid, fe.hop, rounding_mode="floor")
    frame_mask = (torch.arange(n_frames, device=dev)[None, :] < valid[:, None])[:, :, None]
    masked = torch.where(frame_mask, logmel, 0.0)
    denom = torch.clamp_min(valid, 1).float()[:, None, None]
    mean = masked.sum(dim=1, keepdim=True) / denom
    var = torch.where(frame_mask, (logmel - mean) ** 2, 0.0).sum(dim=1, keepdim=True)
    std = torch.sqrt(var / torch.clamp_min(denom - 1.0, 1.0))
    out = (logmel - mean) / (std + NORM_EPS)
    return torch.where(frame_mask, out, 0.0), valid.to(torch.int32)


def parakeet_log_mel(audio: torch.Tensor, n_valid: torch.Tensor,
                     fe: Frontend = Frontend()) -> tuple[torch.Tensor, torch.Tensor]:
    """Parakeet's normalized log-mel for a batch: audio (B, N) f32 with each
    row zero-padded past its n_valid ((B,) int32 on the audio's device) ->
    ((B, 1 + N // hop, n_mels) f32, (B,) int32 valid frames n_valid // hop).
    A row with n_valid 0 comes out all zero.  CPU tensors take
    :func:`parakeet_log_mel_reference`; CUDA tensors launch
    ``csrc/log_mel.cu`` once for the whole batch and raise on any shape,
    type, layout or launch error."""
    _check_audio(audio, 2, "parakeet log-mel")
    _check_mels(fe.n_mels, fe.n_fft)
    if (n_valid.dim() != 1 or n_valid.shape[0] != audio.shape[0] or n_valid.dtype != torch.int32
            or n_valid.device != audio.device or not n_valid.is_contiguous()):
        raise ValueError(f"parakeet log-mel wants (B,) int32 n_valid on the audio's device; got "
                         f"{tuple(n_valid.shape)} {n_valid.dtype} on {n_valid.device}")
    if audio.shape[1] < 1 or fe.sample_rate != mel_ref.SAMPLE_RATE:
        raise ValueError(f"parakeet log-mel needs at least one sample a row at {mel_ref.SAMPLE_RATE} Hz; got "
                         f"{audio.shape[1]} at {fe.sample_rate} Hz")
    if audio.device.type == "cpu":
        return parakeet_log_mel_reference(audio, n_valid, fe)
    rows, n = audio.shape
    plan = device_plan(True, rows, n, fe.n_mels, audio.device, fe.n_fft, fe.hop)
    out = torch.empty((rows, 1 + n // fe.hop, fe.n_mels), dtype=torch.float32, device=audio.device)
    frames = torch.empty((rows,), dtype=torch.int32, device=audio.device)
    _launch(True, audio, n_valid, out, frames, _tables("parakeet", fe.n_fft, fe.win_length, fe.n_mels,
                                                       audio.device),
            fe.n_fft, fe.hop, fe.n_mels, fe.preemphasis, plan)
    _build.count_launch(parakeet_log_mel)
    return out, frames


parakeet_log_mel.launches = 0

