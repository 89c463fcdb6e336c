"""Convert HF/torch checkpoints into the framework's ``.npz`` format with the
port alone: no JAX, no ``s2s_tpu``, no ``safetensors`` and no ``ml_dtypes``.

Usage (the source checkpoint must be local)::

    python -m s2s_tpu_torch.tools.convert_checkpoint --family smollm2-1.7b \\
        --src /path/to/model.safetensors --out smollm2.npz
    python -m s2s_tpu_torch.tools.convert_checkpoint --family distil-large-v3 \\
        --src /path/to/model.safetensors --out distil.npz --device cpu

The families, flags and behaviour of ``scripts/convert_checkpoint.py``
(``mms-vits``'s ``vits.`` prefix stripped and its ``vocab.json`` sidecar,
Kokoro's ``config.json`` vocab sidecar, a kokoro ``.pth``'s nested
``{module: state_dict}`` with ``module.`` stripped, a bare tensor read as
``{"pack": ...}``, ``--mvn`` and ``--pred-layers``), plus ``--device``: each
family's converter (``convert_*`` in the port's model modules) does its
numpy arithmetic on the host and casts each tensor on that device, as
``jnp.asarray`` casts on JAX's.  The default is ``cuda``, with no fallback:
on a machine without a card it raises, so pass ``--device cpu`` there.

Reading: ``.safetensors`` through :class:`SafetensorsFile`, this module's own
reader (the 8-byte header length, the JSON header, the data offsets; BF16
comes in as its bits and becomes a ``torch.bfloat16`` tensor without
rounding); ``.pt``, ``.bin`` and ``.ckpt`` through ``torch.load(...,
weights_only=True)``.  Entries are read when a converter takes them.

Writing: :func:`flatten_items` gives the arrays ``scripts/convert_checkpoint.py``'s
``flatten`` gives, array for array (``/``-joined keys, list indices as
segments), with a bf16 leaf as the ``|V2`` view of its bits, which is how
``np.load`` reads back the bf16 leaves that script writes; both packages'
loaders read either file.  The file is ``np.savez``'s layout, uncompressed
(:func:`save_npz`, one array at a time off the device): the weights' low
mantissa bits are close to random, so zip compression keeps most of the size
and makes the write many times slower, which at the full width of a 1.7B
model is most of a conversion.  ``np.load`` reads both kinds.  The last line printed gives the
array and parameter counts and the process's peak resident memory
(sampled, :class:`PeakRss`).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import struct
import threading
import zipfile
from collections.abc import Iterator, Mapping
from dataclasses import replace
from typing import Any

import numpy as np
import torch

FAMILIES = ["smollm2-1.7b", "smollm2-360m", "whisper-tiny", "whisper-base",
            "whisper-small", "whisper-large-v3", "distil-large-v3", "silero-vad",
            "parakeet-tdt-0.6b-v2", "parakeet-tdt-0.6b-v3",
            "qwen3-tts-12hz-1.7b", "smart-turn", "mms-vits",
            "kokoro", "kokoro-voice", "smolvlm-vision",
            "paraformer-large", "mimi", "pocket-tts",
            "pocket-voice", "chattts", "deepfilter"]

# safetensors dtype -> the numpy dtype its bytes are read as (BF16: its bits)
_ST_NUMPY = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
             "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
             "BOOL": np.bool_}
_ST_NAME = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
            torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
            torch.bool: "BOOL"}


class SafetensorsFile(Mapping):
    """The tool's safetensors reader: a ``.safetensors`` file as a read-only
    mapping name -> tensor on the CPU; each entry is read from the file when
    it is looked up."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self._header = header
        self._base = 8 + n

    def __getitem__(self, name: str) -> torch.Tensor:
        info = self._header[name]
        kind = info["dtype"]
        if kind not in _ST_NUMPY:
            raise ValueError(f"{self.path}: {name} has dtype {kind}, which this reader does not read")
        start, end = info["data_offsets"]
        with open(self.path, "rb") as f:
            f.seek(self._base + start)
            raw = f.read(end - start)
        arr = np.frombuffer(raw, dtype=np.dtype(_ST_NUMPY[kind]).newbyteorder("<")).copy()
        t = torch.from_numpy(arr.reshape(info["shape"]))
        return t.view(torch.bfloat16) if kind == "BF16" else t

    def __contains__(self, name: object) -> bool:
        return name in self._header

    def __iter__(self) -> Iterator[str]:
        return iter(self._header)

    def __len__(self) -> int:
        return len(self._header)


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """Write *tensors* as a ``.safetensors`` file (little-endian, the header
    padded with spaces to 8 bytes), one tensor at a time."""
    header: dict[str, Any] = {}
    offset = 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAME[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            t = t.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().tobytes())


def load_state_dict(path: str) -> Mapping:
    """A checkpoint file -> name -> tensor (``scripts/convert_checkpoint.py``'s
    ``load_state_dict``, with tensors where that one gives numpy arrays)."""
    if path.endswith(".safetensors"):
        return SafetensorsFile(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, torch.Tensor):  # e.g. a kokoro voicepack .pt
        return {"pack": sd}
    flat = {}
    for k, v in sd.items():
        if isinstance(v, dict):  # kokoro-v1_0.pth: {module: state_dict} nesting
            for k2, v2 in v.items():
                k2 = k2[7:] if k2.startswith("module.") else k2
                flat[f"{k}.{k2}"] = v2
        else:
            flat[k] = v
    return flat


def host_leaf(value: Any) -> np.ndarray:
    """A converted leaf as the array the JAX script's ``flatten`` stores: a
    bf16 tensor as the ``|V2`` view of its bits."""
    if not isinstance(value, torch.Tensor):
        return np.asarray(value)
    value = value.detach().cpu()
    if value.dtype == torch.bfloat16:
        return value.view(torch.int16).numpy().view(np.dtype("V2"))
    return value.numpy()


def flatten_items(tree: Any, prefix: str = "") -> Iterator[tuple[str, np.ndarray]]:
    """(key, array) of every leaf of a nested dict/list tree, in the JAX
    script's order and naming, one leaf at a time."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], host_leaf(tree)


def flatten(tree: Any) -> dict[str, np.ndarray]:
    return dict(flatten_items(tree))


def save_npz(path: str, items: Iterator[tuple[str, np.ndarray]]) -> tuple[int, int]:
    """``np.savez``'s file (a stored zip of ``<key>.npy`` members; ``.npz``
    appended to *path* if it lacks it), written one array at a time.
    Returns the arrays and elements written."""
    if not path.endswith(".npz"):
        path += ".npz"
    n_arrays = n_elements = 0
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, arr in items:
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)
            n_arrays += 1
            n_elements += arr.size
    return n_arrays, n_elements


def parse_kaldi_mvn(path: str) -> tuple[np.ndarray, np.ndarray]:
    """FunASR am.mvn (Kaldi nnet text): <AddShift> vector = -mean,
    <Rescale> vector = 1/std.  Returns (add_shift, rescale)."""
    import re

    text = open(path).read()
    vectors = re.findall(r"\[([^\]]+)\]", text)
    arrays = [np.fromstring(v, sep=" ", dtype=np.float32) for v in vectors]
    arrays = [a for a in arrays if a.size > 1]
    if len(arrays) < 2:
        raise ValueError(f"Could not find AddShift/Rescale vectors in {path}")
    return arrays[0], arrays[1]


def _single(sd: Mapping):
    """A one-entry file's tensor (voice tables), else the mapping itself."""
    return next(iter(sd.values())) if isinstance(sd, Mapping) and len(sd) == 1 else sd


def _write_sidecar(out: str, vocab, what: str) -> None:
    with open(out + ".vocab.json", "w") as f:
        json.dump(vocab, f, ensure_ascii=False)
    print(f"wrote {out}.vocab.json ({len(vocab)} {what})")


def convert(family: str, sd: Mapping, device: torch.device, src: str = "", out: str = "",
            mvn: str | None = None, pred_layers: int = 1) -> Any:
    """*family*'s converter on *sd*, as ``scripts/convert_checkpoint.py``'s
    ``main`` dispatches it; the sidecars go next to *out*."""
    from s2s_tpu_torch.models.common import host_array

    if family.startswith("smollm2"):
        from s2s_tpu_torch.models import decoder_lm

        cfg = {"smollm2-1.7b": decoder_lm.DecoderLMConfig.smollm2_1_7b,
               "smollm2-360m": decoder_lm.DecoderLMConfig.smollm2_360m}[family]()
        return decoder_lm.convert_hf_state_dict(sd, cfg, device)
    if family.startswith("parakeet-tdt"):
        from s2s_tpu_torch.models import parakeet

        cfg = {"parakeet-tdt-0.6b-v2": parakeet.ParakeetConfig.tdt_0_6b_v2,
               "parakeet-tdt-0.6b-v3": parakeet.ParakeetConfig.tdt_0_6b_v3}[family]()
        return parakeet.convert_state_dict(sd, replace(cfg, pred_layers=pred_layers), device)
    if family == "qwen3-tts-12hz-1.7b":
        from s2s_tpu_torch.models import qwen3_tts

        return qwen3_tts.convert_state_dict(sd, qwen3_tts.Qwen3TTSConfig.qwen3_tts_12hz_1_7b(), device)
    if family == "mms-vits":
        from s2s_tpu_torch.models import vits

        sd = {k[5:] if k.startswith("vits.") else k: v for k, v in sd.items()}
        vocab_size = sd["text_encoder.embed_tokens.weight"].shape[0]
        params = vits.convert_hf_state_dict(sd, replace(vits.VitsConfig(), vocab_size=vocab_size), device)
        vocab_path = os.path.join(os.path.dirname(src) or ".", "vocab.json")
        if os.path.exists(vocab_path):
            with open(vocab_path) as f:
                _write_sidecar(out, json.load(f), "symbols")
        return params
    if family == "paraformer-large":
        from s2s_tpu_torch.models import paraformer

        params = paraformer.convert_state_dict(sd, paraformer.ParaformerConfig(), device)
        if mvn:
            mean, scale = parse_kaldi_mvn(mvn)
            params["cmvn_mean"] = torch.from_numpy(mean).to(device)
            params["cmvn_scale"] = torch.from_numpy(scale).to(device)
        return params
    if family == "smolvlm-vision":
        from s2s_tpu_torch.models import vision

        return vision.convert_hf_state_dict(sd, vision.VisionConfig(), device)
    if family == "kokoro":
        from s2s_tpu_torch.models import kokoro

        params = kokoro.convert_state_dict(sd, kokoro.KokoroConfig(), device)
        # hexgrad/Kokoro-82M ships the phoneme vocab in config.json
        cfg_path = os.path.join(os.path.dirname(src) or ".", "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                vocab = json.load(f).get("vocab")
            if vocab:
                _write_sidecar(out, vocab, "phonemes")
        return params
    if family == "kokoro-voice":
        # a voicepack .pt: (510, 1, 2*style) length-indexed style table
        pack = np.asarray(host_array(_single(sd)), np.float32).reshape(-1, 256)
        return {"pack": torch.from_numpy(pack).to(device)}
    if family == "mimi":
        from s2s_tpu_torch.models import mimi

        return mimi.convert_state_dict(sd, mimi.MimiConfig(), device)
    if family == "pocket-tts":
        from s2s_tpu_torch.models import pocket_tts

        return pocket_tts.convert_state_dict(sd, pocket_tts.PocketTTSConfig(), device)
    if family == "chattts":
        from s2s_tpu_torch.models import chattts

        return chattts.convert_state_dict(sd, chattts.ChatTTSConfig(), device)
    if family == "deepfilter":
        from s2s_tpu_torch.models import deepfilter

        return deepfilter.convert_state_dict(sd, deepfilter.DeepFilterConfig(), device)
    if family == "pocket-voice":
        # a kyutai tts-voices embedding file: (T_v, d_model) prefix rows
        voice = np.asarray(host_array(_single(sd)), np.float32)
        return {"voice": torch.from_numpy(np.require(voice, requirements=("C", "W"))).to(device)}
    if family == "smart-turn":
        from s2s_tpu_torch.vad import smart_turn

        return smart_turn.convert_state_dict(sd, device=device)
    if family == "silero-vad":
        from s2s_tpu_torch.models.silero_vad import convert_silero_state_dict

        return convert_silero_state_dict(sd, device)
    from s2s_tpu_torch.models import whisper

    cfg = {"whisper-tiny": whisper.WhisperConfig.tiny, "whisper-base": whisper.WhisperConfig.base,
           "whisper-small": whisper.WhisperConfig.small, "whisper-large-v3": whisper.WhisperConfig.large_v3,
           "distil-large-v3": whisper.WhisperConfig.distil_large_v3}[family]()
    return whisper.convert_hf_state_dict(sd, cfg, device=device)


def rss_bytes() -> int:
    """This process's resident set now (``VmRSS``), or, where ``/proc`` has
    none, its peak as the kernel keeps it (``ru_maxrss``, KiB on Linux)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class PeakRss:
    """The largest resident set seen while the block runs, sampled every
    10 ms by a thread: the kernel's own peak counters (``ru_maxrss``, and
    ``VmHWM`` on some kernels) can carry a forking parent's peak
    into a child process."""

    def __enter__(self) -> "PeakRss":
        self.start = self.peak = rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, rss_bytes())

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--family", required=True, choices=FAMILIES)
    parser.add_argument("--mvn", default=None, help="paraformer: FunASR am.mvn (Kaldi text) for CMVN")
    parser.add_argument("--pred-layers", type=int, default=1,
                        help="parakeet prediction-network LSTM layers (per the checkpoint)")
    parser.add_argument("--src", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cuda",
                        help="where each tensor is cast (default cuda, no fallback; cpu on a machine without a card)")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is visible to PyTorch (pass --device cpu)")
        torch.empty(0, device=device)  # the CUDA context, in the resident set before converting
    with PeakRss() as rss:
        params = convert(args.family, load_state_dict(args.src), device, args.src, args.out, args.mvn,
                         args.pred_layers)
        n_arrays, n_elements = save_npz(args.out, flatten_items(params))
    print(f"wrote {args.out}: {n_arrays} arrays, {n_elements / 1e6:.1f}M params, "
          f"peak RSS {rss.peak / 2**20:.1f} MiB ({rss.start / 2**20:.1f} MiB before converting)")


if __name__ == "__main__":
    main()
