"""Cross-session micro-batched Parakeet on PyTorch (port of the device side
of ``s2s_tpu/runtime/batcher.py::BatchedParakeetSTT``).

The JAX service's host logic is inherited: the :class:`MicroBatcher` that
coalesces concurrent sessions' transcribe windows, grouping by audio bucket
and padding to a width bucket with inert rows (``n_valid == 0``).  The
batch itself runs :func:`s2s_tpu_torch.models.parakeet.transcribe_step_batch`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from s2s_tpu.runtime.batcher import BatchedParakeetSTT as _JaxBatchedParakeetSTT
from s2s_tpu_torch.models import parakeet

#: default warm-up buckets (seconds): progressive ticks and short finals are
#: warmed at every width, long utterances and the window cap at 1 and the max
SHORT_S = (1, 2, 3)
LONG_S = (5, 15)


class BatchedParakeetSTT(_JaxBatchedParakeetSTT):
    """Shared Parakeet service: concurrent windows in one batched call."""

    def __init__(self, params: Any, cfg: Any, device: torch.device | str = "cpu", window_s: float = 0.003,
                 max_batch: int = 16) -> None:
        super().__init__(params, cfg, window_s=window_s, max_batch=max_batch)
        self.device = torch.device(device)

    def _transcribe(self, batch: np.ndarray, n_valid: list[int]) -> list[list[int]]:
        audio = torch.from_numpy(batch).to(self.device)
        return parakeet.transcribe_step_batch(self.params, self.cfg, audio, n_valid)

    def _run_batch(self, slots: list[int], arrays: list[Any]) -> list[Any]:
        groups: dict[int, list[int]] = {}
        for i, (audio, _nv) in enumerate(arrays):
            groups.setdefault(int(audio.shape[0]), []).append(i)
        results: list[Any] = [None] * len(arrays)
        for length, idxs in groups.items():
            width = self._width(len(idxs))
            batch = np.zeros((width, length), np.float32)
            nv = [0] * width  # padding rows: n_valid 0, inert
            for row, i in enumerate(idxs):
                batch[row] = arrays[i][0]
                nv[row] = int(arrays[i][1])
            tokens = self._transcribe(batch, nv)
            for row, i in enumerate(idxs):
                results[i] = tokens[row]
        return results

    def warmup(self, lengths: tuple[int, ...] = (), widths: tuple[int, ...] = ()) -> None:
        """Run the hot (width, length-bucket) batches once.  *lengths* (in
        samples) and *widths* each default on their own: given lengths run
        at the default widths, given widths at the default lengths."""
        max_w = self._batcher._max_batch
        default_widths = [w for w in self.WIDTHS if w <= max_w]
        short = [int(s * 16000) for s in SHORT_S]
        longer = [int(s * 16000) for s in LONG_S]
        if lengths or widths:
            pairs = [(l, w) for l in (lengths or short + longer) for w in (widths or default_widths)]
        else:
            pairs = [(l, w) for l in short for w in default_widths]
            pairs += [(l, w) for l in longer for w in sorted({1, max_w})]
        for length, width in pairs:
            self._transcribe(np.zeros((width, length), np.float32), [0] * width)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
