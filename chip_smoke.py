"""Smoke test of the PyTorch/CUDA port (``s2s_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, each printed on its own line:

1. the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
   no CUDA device -> exit 1 before anything else;
2. build every kernel from ``s2s_tpu_torch/csrc/`` with nvcc;
3. each kernel against its plain PyTorch version at the serving path's
   shapes, in bf16, bound 2 bf16 ulps of max|plain|; device times of both,
   taken in turns (plain, kernel, kernel, plain) with CUDA graphs over
   enough weight or cache copies to exceed the 50 MB L2: ``int8_matmul``
   (``weight_only_phase``: the launch plan printed at every row, a
   duplicated row bit-equal, ``torch._weight_int8pack_mm`` and the bf16
   ``torch.matmul`` of the dequantized weight timed beside it, and the other
   regime's time at up to 8 rows), then ``decode_attention`` (tail form at the SmolLM2-1.7B and Qwen3-TTS
   talker shapes and the talker at its max_seq_len 4096, whose keys stream
   through a ring of tiles, with ``F.scaled_dot_product_attention`` timed
   beside it at every shape and the launch plan (cluster size, tile rows,
   stages) printed; rows duplicated at B 4 and 16
   must come out bitwise equal; then the Pallas-contract form, whose caches
   must come out bitwise equal to the plain version's);
4. tiny configs on the card against the same code on the CPU: the single-
   session models, then the batched LM and talker tail programs (the CPU
   path is held against the JAX package by ``tests/test_torch_port_*``);
5. the full-width single-session serve built by the port's builder with
   ``scripts/run_soak.py``'s ``--sessions 1`` flags, random weights from a
   seed, a warm-up text turn, then over a real WebSocket on 127.0.0.1 one
   text turn (audio deltas + response.done) and one audio turn (a
   transcription event, then, unless the random-init transcript is empty, a
   spoken reply with response.done); the int8 kernel's launch count over
   those two turns must be > 0, and the Parakeet frontend's log-mel
   launches exactly one per transcription batch (> 0);
6. the full-width 4-session batched serve with ``scripts/run_soak.py``'s
   ``--sessions 4`` flags (batched LM, TTS and Parakeet engines, warmed at
   build): four WebSocket clients send one text turn each at the same
   moment and must each get audio deltas and response.done, then one audio
   turn; both kernels' launch counts over those turns must be > 0 (the
   weight-only kernels' launches are also printed by rows), and the
   Parakeet frontend's log-mel launches exactly one per transcription
   batch (> 0);
7. one more concurrent 4-session round of that serve under
   ``torch.profiler`` (device activity only): the device's busy share
   between the round's first and last kernel, the kernels launched, and the
   kernels with the most device time;
8. the W8A8-dynamic and packed-int4 kernels against their plain versions
   (``int8_matmul_dyn`` bit-equal at the int8 shapes x rows 8, 16, 17, 32
   and 64, with its launch plan, the W8A16 kernel on the same weights and,
   above 16 rows, ``torch._int_mm`` plus its epilogue timed beside it; its
   SASS must hold int8 ``wgmma`` (IGMMA) and a call must allocate only its
   output; ``int4_matmul`` within 2 bf16 ulps at the code-predictor and LM shapes,
   as ``weight_only_phase`` runs ``int8_matmul``, with tinygemm's
   ``torch._weight_int4pack_mm`` as its library call);
9. ``w8a8_microbench``, the port of ``scripts/microbench_w8a8.py``: the W8A8
   error against f32 at 16 rows x 2048 x 8192, then its seven-linear,
   24-layer, 8-step mix at 16 rows through the W8A8 kernel and through the
   W8A16 kernel, in GB/s of int8 weights;
10. the tiny f32 models on the card against the CPU under ``int8-dyn``,
   ``int4`` (LM) and ``int8-dyn``, ``int8+cp4``, ``int4`` (Qwen3-TTS);
11. the batched serve of phase 6 at 8 sessions (``QUANT_SERVE_FLAGS``: 8
   pipelines, 8 LM and TTS slots) with ``--llm_quantize int8-dyn
   --tts_quantize int8+cp4``, after the first has shut down: one concurrent
   round of 8 text turns, each answered with audio and response.done; the
   kernels' launches from the build (engine warm-up included) to the end of
   the round, with ``int8_matmul_dyn`` (the LM's 8-row steady steps) and
   ``int4_matmul`` each > 0 in the round, and the round's int8, W8A8 and
   int4 launches by rows.

12. ``flash_attention`` against its plain version in bf16 at the distil-
   large-v3 encoder's shapes (20 heads of 64 x every Whisper duration
   bucket, 50-1500 positions), at Smart Turn's (6 heads x 400) and one
   causal shape, within 2 bf16 ulps of max|plain|, with device times of
   the kernel, the plain version and ``F.scaled_dot_product_attention``,
   the tensor-core kernel's tiles and stages, and a duplicated head that
   must come out bitwise equal to the head it copies;
13. ``log_mel``: the log-mel kernel (one cooperative launch, the log steps
   inside) against the plain torch log-mel at 1, 8 and 30 s x 80 and 128
   mels, within ``LOG_MEL_ATOL`` on the log-mel output, a second run
   bitwise equal, one launch a call, with its launch plan and device times
   of both and of ``torch.stft`` + power + filterbank + the same log steps;
   its bound counts the function's own minimum (a real FFT per frame, audio
   in and log-mel out), and the direct DFT's count stands beside it as
   ``direct_dft_bound_ms``; a grid larger than the card holds at once must
   be refused and leave its output untouched; then ``parakeet_log_mel``,
   Parakeet's batched frontend on the same kernel, at widths 1, 4 and 16 x
   the 1, 3 and 15 s buckets (rows of differing n_valid, and at widths 4
   and 16 a padding row that must come out exactly zero) against the plain
   batched version within ``PARAKEET_MEL_RTOL`` x max|plain|, bitwise
   repeatable, one launch a batch, with device times of the kernel, the
   plain batched version, the per-row plain loop it replaced and
   ``torch.stft`` + power + filterbank + log + the masked normalization;
14. tiny Whisper (``test_tiny`` at head dim 64, so the encoder takes the
   flash kernel), Smart Turn's chain and the voice-clone speaker on the card
   against the same code on the CPU;
15. ``whisper_serve``: the single-session serve with energy VAD, Smart Turn
   on and full-width distil-large-v3 Whisper (``WHISPER_FLAGS``), after the
   earlier serves shut down: one text turn, then voice turns (``VOICE_TONES_HZ``,
   up to the first one answered), each with a non-empty transcription; the
   answered one must bring reply audio and ``response.done``; Smart Turn
   predictions with none failed, and launches of both new kernels that
   match the encodes (one flash launch per encoder layer, one log-mel per
   encode).

Phases 3, 4, 8, 9, 10, 12, 13 and 14 run with TF32 off, so that f32 products
are compared in full f32; the serves run with torch's defaults, as
``s2s_tpu_torch.cli`` does.  Every kernel's line and the JSON line give its
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the card's peak for their type.

After the phases come the card's ``nvidia-smi`` name and power limit, then,
on the line before the last, a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before those lines.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import logging
import math
import subprocess
import sys
import threading
import time

import numpy as np
import torch

FULL_FLAGS = [
    "--host", "127.0.0.1", "--port", "0",
    "--vad_backend", "energy", "--vad_smart_turn", "false",
    "--stt", "parakeet-tdt", "--stt_model_size", "0.6b",
    "--llm_backend", "local-jax", "--llm_model_size", "smollm2-1.7b",
    "--llm_batched_slots", "1", "--llm_quantize", "int8", "--llm_max_new_tokens", "64",
    "--tts", "qwen3", "--tts_model_size", "1.7b", "--tts_batched_slots", "1",
    "--tts_quantize", "int8", "--tts_streaming_chunk_size", "3",
    "--num_pipelines", "1",
]
#: ``scripts/run_soak.py --sessions 4`` (its ``server_command``, full width)
BATCHED_FLAGS = [
    "--host", "127.0.0.1", "--port", "0",
    "--num_pipelines", "4", "--vad_backend", "energy", "--vad_smart_turn", "false",
    "--stt", "parakeet-tdt", "--llm_backend", "local-jax", "--llm_batched_slots", "4",
    "--llm_batched_max_t", "512", "--llm_quantize", "int8", "--llm_chunk_tokens", "6",
    "--llm_max_new_tokens", "64", "--llm_stream_batch_sentences", "1", "--llm_compact_history", "false",
    "--chat_size", "2", "--tts", "qwen3", "--tts_batched_slots", "4", "--tts_batched_max_t", "192",
    "--tts_context_frames", "8", "--tts_streaming_chunk_size", "3", "--warmup_engines", "true",
    "--stt_model_size", "0.6b", "--llm_model_size", "smollm2-1.7b", "--tts_model_size", "1.7b",
]
SESSIONS = 4


def _with(flags: list[str], **values) -> list[str]:
    out = list(flags)
    for name, value in values.items():
        out[out.index(f"--{name}") + 1] = str(value)
    return out


#: the single-session serve with Whisper distil-large-v3 and Smart Turn on
WHISPER_FLAGS = _with(FULL_FLAGS, stt="whisper", stt_model_size="distil-large-v3", vad_smart_turn="true")
#: voice-turn tones of the Whisper serve, tried in order until one is
#: answered: with random weights the transcript is a string of token ids, and
#: the LLM's greedy reply to some of them is empty (EOS first), which the
#: shared host code answers with no response at all; on an H100 the first
#: three were each answered in a trial, 150, 180, 300 and 330 Hz were not
VOICE_TONES_HZ = (440.0, 520.0, 260.0, 220.0)
#: flash attention at the encoder shapes: (name, heads, positions, causal);
#: distil-large-v3 (20 heads of 64) at every Whisper duration bucket
#: (1, 2, 3, 5, 8, 12, 15, 30 s -> 50-1500 positions), Smart Turn (Whisper
#: tiny's 6 heads over its 8 s window), and one causal shape
FLASH_SHAPES = ([("whisper-distil-large-v3", 20, t, False) for t in (50, 100, 150, 250, 400, 600, 750, 1500)]
                + [("smart-turn", 6, 400, False), ("causal", 20, 1500, True)])
#: the flash shape in the JSON line: Smart Turn, run at every soft end of speech
FLASH_HEADLINE = ("smart-turn", 6, 400, False)
#: encoder layers, one flash launch each per encode
WHISPER_LAYERS, SMART_TURN_LAYERS = 32, 4
#: the log-mel shapes (seconds, mels); Smart Turn's 8 s x 80 stands in the JSON line
LOG_MEL_SHAPES = [(s, m) for s in (1, 8, 30) for m in (80, 128)]
LOG_MEL_HEADLINE = (8, 80)
#: pass mark of the log-mel kernel on the log-mel output ((log10 + 4) / 4,
#: a range of 2): f32 DFTs in two sum orders agree to ~5e-5 at these inputs
LOG_MEL_ATOL = 5e-4
#: Parakeet's frontend: (rows, seconds) over the batcher's widths and the
#: 1, 3 and 15 s buckets; the 4 x 3 s batch stands in PERF.md
PARAKEET_MEL_SHAPES = [(w, s) for w in (1, 4, 16) for s in (1, 3, 15)]
PARAKEET_MEL_HEADLINE = (4, 3)
#: pass mark of the Parakeet frontend, relative to max|plain| of the
#: normalized features: the CPU parity bound against the JAX package (both
#: f32, the DFT as a product there and as an FFT here; the normalization
#: divides by a per-mel std, so an absolute bound would not fit every row)
PARAKEET_MEL_RTOL = 1e-4
#: decode attention at the serving shapes: (name, H, KV, hd, T, tails); T is
#: the engine's --*_batched_max_t, the tails the steady chunk first, then the
#: priority / ramp chunk sizes; last the talker at its max_seq_len, whose
#: keys do not fit a CTA at once and stream through a ring of tiles
ATTN_SHAPES = [("smollm2-1.7b", 32, 32, 64, 512, (6, 1, 2, 4, 8, 12)),
               ("qwen3-tts-talker", 16, 8, 128, 192, (3, 2, 4)),
               ("qwen3-tts-talker-4096", 16, 8, 128, 4096, (3,))]
ATTN_ROWS = [1, 4, 16]
#: the decode-attention shape in the JSON line: the 4-session LM steady chunk
ATTN_HEADLINE = ("smollm2-1.7b", 4, 6)
#: (K, N) of the int8 linears: SmolLM2-1.7B, then the Qwen3-TTS talker and
#: code predictor
INT8_SHAPES = [(2048, 2048), (2048, 8192), (8192, 2048), (2048, 1024), (2048, 6144), (6144, 2048)]
#: rows: single-session decode, 2, the 4-session step, the width buckets 8
#: and 16, 17 (past a bucket), the 32- and 64-token prompt buckets
INT8_ROWS = [1, 2, 4, 8, 16, 17, 32, 64]
#: the shape whose times stand in the JSON line: a talker/code-predictor
#: gate or up projection at decode (1 row)
HEADLINE = (1, 2048, 6144)
#: the W8A8 rows: the 16-, 32- and 64-token prompt buckets, the 8- and
#: 16-slot steady steps (fewer rows take the W8A16 route) and 17 (past a
#: bucket: the kernel rounds its rows up to an s8 wgmma N of 24)
DYN_ROWS = [8, 16, 17, 32, 64]
#: the W8A8 shape in the JSON line: a SmolLM2-1.7B gate/up projection in the
#: 32-token prompt bucket (above 16 rows, so ``torch._int_mm`` runs beside it)
DYN_HEADLINE = (32, 2048, 8192)
#: (K, N) of the int4 linears: the Qwen3-TTS code predictor, then the
#: SmolLM2-1.7B shapes it does not share
INT4_SHAPES = [(2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048), (2048, 8192), (8192, 2048)]
INT4_ROWS = [1, 2, 4, 8, 16, 32, 64]
#: the int4 shape in the JSON line: a code-predictor gate/up projection at
#: the 4-session steady step
INT4_HEADLINE = (4, 2048, 6144)
QUANT_FLAGS = ["--llm_quantize", "int8-dyn", "--tts_quantize", "int8+cp4"]
#: the quantized serve: 8 sessions, so the LM's steady steps have 8 rows and
#: take the W8A8 kernel (at 4 they take the W8A16 route)
QUANT_SESSIONS = 8
QUANT_SERVE_FLAGS = [*BATCHED_FLAGS, *QUANT_FLAGS, "--num_pipelines", str(QUANT_SESSIONS),
                     "--llm_batched_slots", str(QUANT_SESSIONS), "--tts_batched_slots", str(QUANT_SESSIONS)]
TEXT = "What is the weather like today?"
L2_BYTES = 50 << 20
#: H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, dense bf16 FLOP/s, dense int8 OP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
#: f32 on the CUDA cores (outside the tensor cores), NVIDIA's H100 SXM data sheet
F32_FLOPS = 67e12


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


@contextlib.contextmanager
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 2.0 ** -133


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """(least time in ms the card could take, what bounds it): the larger of
    the bytes moved over the HBM rate and the operations over *peak_ops*."""
    by_bytes, by_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def gemv_bound(b: int, k: int, n: int, weight_bytes: float, peak_ops: float) -> tuple[float, str]:
    """The bound of one decode-shaped linear: the weight, x (bf16), the
    scale (f32) and the output (bf16) each moved once; 2*B*K*N operations."""
    return bound(weight_bytes + b * k * 2 + n * 4 + b * n * 2, 2 * b * k * n, peak_ops)


def device_ms(fn, calls: int) -> float:
    """Device time per call: *calls* calls captured in a CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    replays = 5
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def _weight_only_library(fmt: str, q: torch.Tensor, scale: torch.Tensor):
    """The one PyTorch call computing a weight-only linear, for timing beside
    the kernel (the port never calls it): ``torch._weight_int8pack_mm``
    (weight (N, K) int8, bf16 scales) or ``torch._weight_int4pack_mm``
    (tinygemm: the nibbles as unsigned values + 8, packed by
    ``torch._convert_weight_to_int4pack``, the channel scale as group scales
    of 256 rows with zero points 0).  Returns (call(x) -> out, operand
    bytes it reads, or raises where the card's PyTorch does not run it)."""
    from s2s_tpu_torch.ops import int4_matmul as m4

    if fmt == "int8":
        w_nk, s_bf = q.t().contiguous(), scale.to(torch.bfloat16)
        return lambda x: torch._weight_int8pack_mm(x, w_nk, s_bf)
    lo, hi = m4.unpack_nibbles(q)
    u = (torch.cat([lo, hi]) + 8).t().contiguous()  # (N, K), 0..15
    packed = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
    k, n = u.shape[1], u.shape[0]
    groups = scale.expand(k // 256, n)
    sz = torch.stack([groups, torch.zeros_like(groups)], dim=-1).to(torch.bfloat16).contiguous()
    return lambda x: torch._weight_int4pack_mm(x, packed, 256, sz)


def weight_only_phase(dev: torch.device, fmt: str) -> dict:
    """``int8_matmul`` or ``int4_matmul`` against its plain version at the
    served shapes x rows, within 2 bf16 ulps of max|plain|, with the launch
    plan printed, a duplicated row bit-equal to the row it copies, and device
    times (weights cycled past the L2) of the kernel, the plain version, the
    library call (``_weight_only_library``; null with its error where the
    card's PyTorch does not run it) and ``torch.matmul`` with the
    dequantized bf16 weight (the unquantized model's linear); at rows the
    CUDA-core regime takes (up to 8), also the other regime's time, the
    crossover that sets the cutoff."""
    from s2s_tpu_torch.ops import int4_matmul as m4
    from s2s_tpu_torch.ops import int8_matmul as mm
    from s2s_tpu_torch.ops import weight_only as wo

    int8 = fmt == "int8"
    planes = 1 if int8 else 2
    wrapper, ref = (mm.int8_matmul, mm.int8_matmul_reference) if int8 else (m4.int4_matmul, m4.int4_matmul_reference)
    entry = "s2s_int8_matmul" if int8 else "s2s_int4_matmul"
    shapes, row_counts, headline_key = (INT8_SHAPES, INT8_ROWS, HEADLINE) if int8 else (INT4_SHAPES, INT4_ROWS,
                                                                                        INT4_HEADLINE)
    gen = torch.Generator(device=dev).manual_seed(0 if int8 else 7)
    rows, max_err, headline = [], 0.0, None
    for k, n in shapes:
        weight_bytes = k * n // planes
        copies = max(2, -(-2 * L2_BYTES // weight_bytes))
        low = -127 if int8 else -128
        qs = [torch.randint(low, 128, (k // planes, n), generator=gen, device=dev, dtype=torch.int16).to(torch.int8)
              for _ in range(copies)]
        scale = torch.rand(n, generator=gen, device=dev) * 0.01 + 1e-4
        try:
            library = [_weight_only_library(fmt, q, scale) for q in qs]
            library_error = None
        except Exception as e:  # noqa: BLE001 - the yardstick's absence is a result
            library, library_error = None, f"{type(e).__name__}: {e}"[:300]
        dense = [((qs[i % copies] if int8 else torch.cat(m4.unpack_nibbles(qs[i % copies]))).float() * scale)
                 .to(torch.bfloat16) for i in range(max(2, -(-2 * L2_BYTES // (2 * k * n))))]
        for b in row_counts:
            x = torch.randn(b, k, generator=gen, device=dev).to(torch.bfloat16)
            plan = wo.device_plan(b, k, n, planes, dev)
            got = wrapper(x, qs[0], scale)
            want = ref(x, qs[0], scale)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == torch.bfloat16, f"{fmt}_matmul output {got.shape}")
            err = (got.float() - want.float()).abs().max().item()
            tol = 2 * bf16_ulp(want.float().abs().max().item())
            check(math.isfinite(err) and err <= tol, f"{fmt}_matmul B={b} K={k} N={n}: |d|={err} > {tol}")
            max_err = max(max_err, err)
            if b > 1:  # a padded width bucket repeats rows: the copy must come out bit-equal
                xd = x.clone()
                xd[-1] = xd[0]
                gotd = wrapper(xd, qs[0], scale)
                torch.cuda.synchronize()
                check(torch.equal(gotd[-1], gotd[0]), f"{fmt}_matmul B={b} K={k} N={n}: duplicated row differs")

            def plain(i):
                ref(x, qs[i % copies], scale)

            def kernel(i):
                wrapper(x, qs[i % copies], scale)

            times = [device_ms(f, 2 * copies) for f in (plain, kernel, kernel, plain)]
            ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
            bound_ms, bound_by = gemv_bound(b, k, n, weight_bytes, BF16_FLOPS)
            library_ms = library_err = None
            if library is not None:
                try:
                    library_err = (library[0](x).float() - want.float()).abs().max().item()
                    library_ms = device_ms(lambda i: library[i % copies](x), 2 * copies)
                except Exception as e:  # noqa: BLE001
                    library_error = f"{type(e).__name__}: {e}"[:300]
            bf16_ms = device_ms(lambda i: torch.matmul(x, dense[i % len(dense)]), 2 * len(dense))
            row = dict(B=b, K=k, N=n, max_abs_err=err, bound=tol, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms, library_max_abs_err=library_err,
                       library_error=library_error, bf16_ms=bf16_ms,
                       kernel_GBps=weight_bytes / (ms * 1e-3) / 1e9, plan=plan.describe(),
                       duplicate_row_bitwise_equal=b > 1)
            if b <= wo.ROW_TILES[-1]:  # both regimes can run: the crossover
                sms, smem, clusters = wo.device_limits(dev)
                other = wo.launch_plan(b, k, n, sms, smem, planes, regime=1 - plan.regime, clusters=dict(clusters))
                row["other_regime"] = {"plan": other.describe(), "ms": device_ms(
                    lambda i: wo.launch(entry, x, qs[i % copies], scale, planes, other), 2 * copies)}
            phase(f"{fmt}_matmul", **row)
            rows.append(row)
            if (b, k, n) == headline_key:
                headline = row
        del qs, library, dense
    check(headline is not None, f"{fmt}_matmul headline shape measured")
    return {"max_abs_err": max_err, **{key: headline[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                                       "library_ms")}, "rows": rows}


def attention_phase(dev: torch.device) -> dict:
    """decode_attention against its plain version at the serving shapes:
    lengths from a seed, row 0 at the full cache, SDPA timed beside it; rows
    duplicated at B=4 and 16 must come out bit-equal; then the
    Pallas-contract form at B=4, whose caches must match the plain
    version's bit for bit."""
    from s2s_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    # the duplicate-row checks draw from their own streams, so the timed
    # shapes keep the inputs of earlier runs
    dup_gen = torch.Generator(device=dev).manual_seed(2)
    dup_rng = np.random.default_rng(2)
    rows, max_err, headline = [], 0.0, None
    for name, h, kv, hd, t, tails in ATTN_SHAPES:
        for b in ATTN_ROWS:
            cache_bytes = 2 * b * kv * t * hd * 2
            copies = max(2, -(-2 * L2_BYTES // cache_bytes))
            caches = [(torch.randn(b, kv, t, hd, generator=gen, device=dev).to(torch.bfloat16),
                       torch.randn(b, kv, t, hd, generator=gen, device=dev).to(torch.bfloat16))
                      for _ in range(copies)]
            q = torch.randn(b, h, hd, generator=gen, device=dev).to(torch.bfloat16)
            for n in tails:
                tk, tv = (torch.randn(b, kv, n, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
                cache_len = rng.integers(0, t + 1, b).astype(np.int32)
                cache_len[0] = t
                cl = torch.from_numpy(cache_len).to(dev)
                tl = torch.from_numpy(rng.integers(1, n + 1, b).astype(np.int32)).to(dev)
                ck, cv = caches[0]
                plan = da.device_plan(b, kv, t, n, h // kv, hd, 2, dev)
                got = da.concat_attention(q, ck, cv, tk, tv, cl, tl)
                want = da.concat_attention_reference(q, ck, cv, tk, tv, cl, tl)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = 2 * bf16_ulp(want.float().abs().max().item())
                check(got.shape == want.shape and math.isfinite(err) and err <= tol,
                      f"decode_attention {name} B={b} n={n}: |d|={err} > {tol}")
                max_err = max(max_err, err)

                def plain(i):
                    da.concat_attention_reference(q, *caches[i % copies], tk, tv, cl, tl)

                def kernel(i):
                    da.concat_attention(q, *caches[i % copies], tk, tv, cl, tl)

                times = [device_ms(f, 2 * copies) for f in (plain, kernel, kernel, plain)]
                ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
                valid = int(cache_len.sum()) + int(tl.sum().item())
                # K and V of the valid keys, q and the output once; QK and PV
                bound_ms, bound_by = bound(2 * valid * kv * hd * 2 + 2 * b * h * hd * 2,
                                           4 * valid * (h // kv) * kv * hd, BF16_FLOPS)
                row = dict(shape=name, B=b, H=h, KV=kv, hd=hd, T=t, n=n, max_abs_err=err, bound=tol, ms=ms,
                           plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=_sdpa_ms(q, caches, tk, tv, cl, tl),
                           kernel_GBps=2 * valid * kv * hd * 2 / (ms * 1e-3) / 1e9,
                           cluster=plan.cluster, tile_rows=plan.tile_rows, stages=plan.stages)
                phase("decode_attention", **row)
                rows.append(row)
                if (name, b, n) == ATTN_HEADLINE:
                    headline = row
            if b in (4, 16):  # duplicated rows (as a padded width bucket) must come out bit-equal
                n = tails[0]
                tk, tv = (torch.randn(b, kv, n, hd, generator=dup_gen, device=dev).to(torch.bfloat16)
                          for _ in range(2))
                cache_len = dup_rng.integers(0, t + 1, b).astype(np.int32)
                tail_len = dup_rng.integers(1, n + 1, b).astype(np.int32)
                pair = torch.arange(b, device=dev) % 2  # rows 0, 1, 0, 1, ...
                args = [x[pair].contiguous() for x in (q, *caches[0], tk, tv)]
                lens = [torch.from_numpy(x).to(dev)[pair].contiguous() for x in (cache_len, tail_len)]
                got = da.concat_attention(*args, *lens)
                torch.cuda.synchronize()
                check(all(torch.equal(got[i], got[i % 2]) for i in range(b)),
                      f"decode_attention {name} B={b}: duplicated rows differ")
                phase("decode_attention_duplicate_rows", shape=name, B=b, n=n, bitwise_equal=True)
            if b == 4:  # the Pallas contract: slot write at pos + keys <= pos
                k_new, v_new = (torch.randn(b, kv, 1, hd, generator=gen, device=dev).to(torch.bfloat16)
                                for _ in range(2))
                pos = torch.from_numpy(rng.integers(0, t, b).astype(np.int32)).to(dev)
                ref_caches = [c.clone() for c in caches[0]]
                got, gk, gv = da.decode_attention(q, k_new, v_new, *caches[0], pos)
                want, wk, wv = da.decode_attention_reference(q, k_new, v_new, *ref_caches, pos)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = 2 * bf16_ulp(want.float().abs().max().item())
                check(err <= tol, f"decode_attention (Pallas form) {name}: |d|={err} > {tol}")
                check(torch.equal(gk, wk) and torch.equal(gv, wv), f"decode_attention (Pallas form) {name} caches")
                phase("decode_attention_pallas_form", shape=name, B=b, max_abs_err=err, bound=tol,
                      caches_bitwise_equal=True)
            del caches
    check(headline is not None, "decode_attention headline shape measured")
    return {"max_abs_err": max_err, "ms": headline["ms"], "plain_ms": headline["plain_ms"],
            "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"], "library_ms": headline["library_ms"]}


def _sdpa_ms(q, caches, tk, tv, cache_len, tail_len) -> float:
    """Device time of ``F.scaled_dot_product_attention`` over each row's
    [padded cache | tail] with a boolean mask of the valid keys: the one
    PyTorch call that computes the same function (a yardstick; the port
    never calls it)."""
    b, h, hd = q.shape
    t, n = caches[0][0].shape[2], tk.shape[2]
    pos = torch.arange(t + n, device=q.device)
    keep = (pos[None, :] < cache_len[:, None].long()) | (
        (pos[None, :] >= t) & (pos[None, :] < t + tail_len[:, None].long()))
    mask = keep[:, None, None, :]
    kvs = [(torch.cat([ck, tk], dim=2), torch.cat([cv, tv], dim=2)) for ck, cv in caches]
    q4 = q[:, :, None, :]

    def library(i):
        k, v = kvs[i % len(kvs)]
        torch.nn.functional.scaled_dot_product_attention(q4, k, v, attn_mask=mask, enable_gqa=True)

    return device_ms(library, 2 * len(kvs))


def tiny_parity_phase(dev: torch.device) -> None:
    """The tiny f32 models on the card against the same code on the CPU."""
    from s2s_tpu_torch.models import decoder_lm, parakeet, qwen3_tts
    from s2s_tpu_torch.ops.quant import quantize_tree
    from s2s_tpu_torch.weights import tree_to_torch as to

    cfg = decoder_lm.DecoderLMConfig.tiny()
    cpu = quantize_tree(decoder_lm.init_params(cfg, torch.Generator().manual_seed(1)), min_size=1)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(1, 256, (1, 16)).astype(np.int32))
    out = {}
    for label, device, params in (("cpu", "cpu", cpu), ("cuda", dev, to(cpu, dev))):
        state = decoder_lm.init_decode_state(cfg, 1, max_t=40, device=device)
        logits, state = decoder_lm.prefill(params, cfg, tokens.to(device), state, 13)
        toks, _, _, _ = decoder_lm.decode_chunk(params, cfg, logits.argmax(-1).to(torch.int32), state, 16, -1)
        out[label] = (logits.cpu(), toks.cpu())
    rel = ((out["cpu"][0] - out["cuda"][0]).abs().max() / out["cpu"][0].abs().max()).item()
    check(rel <= 1e-4, f"decoder_lm logits cuda vs cpu rel {rel}")
    check(torch.equal(out["cpu"][1], out["cuda"][1]), "decoder_lm greedy tokens cuda vs cpu")

    pcfg = parakeet.ParakeetConfig.test_tiny()
    pcpu = parakeet.init_params(pcfg, torch.Generator().manual_seed(2))
    audio = (0.3 * np.random.default_rng(1).standard_normal(24_000)).astype(np.float32)
    ptoks = {label: parakeet.transcribe_tokens(p, pcfg, audio, device=d)
             for label, d, p in (("cpu", "cpu", pcpu), ("cuda", dev, to(pcpu, dev)))}
    check(ptoks["cpu"] == ptoks["cuda"] and len(ptoks["cpu"]) > 0, f"parakeet tokens {ptoks}")

    qcfg = qwen3_tts.Qwen3TTSConfig.tiny()
    qcpu = qwen3_tts.init_params(qcfg, torch.Generator().manual_seed(3))
    chunks = {}
    for label, device, params in (("cpu", "cpu", qcpu), ("cuda", dev, to(qcpu, dev))):
        model = qwen3_tts.Qwen3TTS(params=params, cfg=qcfg, chunk_frames=3, int8=True, device=device)
        chunks[label] = [a for a, _ in model.stream("Hello there.", max_new_tokens=9)]
    check([len(a) for a in chunks["cpu"]] == [len(a) for a in chunks["cuda"]], "qwen3 chunk lengths")
    ref = np.concatenate(chunks["cpu"])
    rel = float(np.abs(ref - np.concatenate(chunks["cuda"])).max() / max(np.abs(ref).max(), 1e-12))
    check(rel <= 1e-4, f"qwen3 audio cuda vs cpu rel {rel}")
    phase("tiny_parity", decoder_lm_tokens=out["cpu"][1].shape[0], parakeet_tokens=len(ptoks["cpu"]),
          qwen3_chunks=len(chunks["cpu"]), qwen3_audio_rel_err=rel)


def tiny_batched_parity_phase(dev: torch.device) -> None:
    """The batched LM and talker tail programs at tiny widths (head_dim 64,
    which the decode-attention kernel takes; f32) on the card against the
    same code on the CPU: greedy tokens and codes equal, audio within 1e-4."""
    import dataclasses

    from s2s_tpu_torch.models import decoder_lm, qwen3_tts
    from s2s_tpu_torch.ops import decode_attention as da
    from s2s_tpu_torch.parallel import batched_decode as bd
    from s2s_tpu_torch.weights import tree_to_torch as to

    before = da.concat_attention.launches
    cfg = decoder_lm.DecoderLMConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256,
                                     max_seq_len=128, head_dim_override=64, dtype=torch.float32)
    cpu = decoder_lm.init_params(cfg, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(4)
    prompts = [torch.from_numpy(rng.integers(1, 256, (1, 16)).astype(np.int32)) for _ in range(3)]
    lm = {}
    for label, device, params in (("cpu", "cpu", cpu), ("cuda", dev, to(cpu, dev))):
        state = bd.init_multi_state(cfg, 3, max_t=64, device=device)
        for slot, plen in enumerate((11, 4, 16)):
            bd.prefill_slot(params, cfg, prompts[slot].to(device), plen, state, slot)
        ids = torch.tensor([0, 2, 2, 2], device=device)
        toks, emitted, _, state = bd.decode_chunk_gathered_tail(
            params, cfg, torch.tensor([5, 6, 6, 6], dtype=torch.int32, device=device), state, 8, -1, ids)
        lm[label] = (toks.cpu(), emitted.cpu(), state.pos.cpu())
    check(all(torch.equal(a, b) for a, b in zip(lm["cpu"], lm["cuda"])), "batched LM tokens cuda vs cpu")

    qcfg = qwen3_tts.Qwen3TTSConfig.tiny()
    qcfg = dataclasses.replace(qcfg, lm=dataclasses.replace(qcfg.lm, head_dim_override=64))
    qcpu = qwen3_tts.init_params(qcfg, torch.Generator().manual_seed(5))
    text = torch.from_numpy(rng.integers(1, 256, (1, 16)).astype(np.int32))
    tts = {}
    for label, device, params in (("cpu", "cpu", qcpu), ("cuda", dev, to(qcpu, dev))):
        state = bd.init_multi_state(qcfg.lm, 3, max_t=64, device=device)
        ctx = torch.zeros((3, 4, qcfg.n_q), dtype=torch.int32, device=device)
        embeds = torch.zeros((3, qcfg.lm.d_model), device=device)
        audio = []
        for slot in (0, 2):
            a, _, emb, state, ctx = qwen3_tts.prefill_and_first_chunk_slot_tail(
                params, qcfg, text.to(device), params["speakers"][slot : slot + 1], state, ctx, 2, slot)
            embeds[slot] = emb
            audio.append(a)
        a, eos, embeds, state, ctx = qwen3_tts.decode_chunk_audio_gathered_tail(
            params, qcfg, embeds, state, ctx, 3, torch.tensor([0, 2, 2, 2], device=device))
        tts[label] = ([x.cpu() for x in audio] + [a.cpu()], eos.cpu(), ctx.cpu())
    check(torch.equal(tts["cpu"][1], tts["cuda"][1]) and torch.equal(tts["cpu"][2], tts["cuda"][2]),
          "batched talker codes and EOS cuda vs cpu")
    rel = max(float((r - c).abs().max() / max(r.abs().max().item(), 1e-12))
              for r, c in zip(tts["cpu"][0], tts["cuda"][0]))
    check(rel <= 1e-4, f"batched talker audio cuda vs cpu rel {rel}")
    launches = da.concat_attention.launches - before
    check(launches > 0, "the tiny batched programs launched the decode-attention kernel")
    phase("tiny_batched_parity", lm_tokens=list(lm["cpu"][0].shape), talker_audio_rel_err=rel,
          decode_attention_launches=launches)


def _int_mm_ms(x, qs, scale) -> float:
    """Device time of the library W8A8: the activation quantize in plain
    torch ops, ``torch._int_mm`` (which takes more than 16 rows) and the
    epilogue; a yardstick the port never calls."""

    def library(i):
        x32 = x.float()
        amax = x32.abs().amax(dim=1, keepdim=True)
        xscale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
        xq = torch.clamp(torch.round(x32 / xscale), -127, 127).to(torch.int8)
        acc = torch._int_mm(xq, qs[i % len(qs)])
        ((acc.float() * xscale) * scale).to(torch.bfloat16)

    return device_ms(library, 2 * len(qs))


def _gmma_ops(library: str) -> dict[str, dict[str, int]]:
    """Tensor-core instructions (``IGMMA``: int8 wgmma; ``HGMMA``: bf16) in
    the SASS of each W8A8 kernel of the built library, by ``cuobjdump``."""
    import re
    from pathlib import Path

    from s2s_tpu_torch.ops import _build

    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
        elif name and "w8a8" in name:
            for op in ("IGMMA", "HGMMA"):
                if re.search(rf"\b{op}\b", line):
                    found.setdefault(name, {op: 0 for op in ("IGMMA", "HGMMA")})[op] += 1
    return found


def int8_dyn_phase(dev: torch.device, library: str) -> dict:
    """``int8_matmul_dyn`` against its plain version at the int8 shapes and
    ``DYN_ROWS``: bit-equal (error 0), with the launch plan and device times
    of the kernel, the plain version, the W8A16 kernel on the same weights
    and, above 16 rows, ``torch._int_mm`` plus its epilogue.  Before that:
    the kernel's SASS holds int8 wgmma and no bf16 one, and a call allocates
    only its output (no xq, scale or int32 workspace in device memory)."""
    from s2s_tpu_torch.ops import int8_matmul as mm
    from s2s_tpu_torch.ops import weight_only as wo

    ops = _gmma_ops(library)
    check(len(ops) == len(wo.W8A8_ROWS) and all(v["IGMMA"] > 0 and v["HGMMA"] == 0 for v in ops.values()),
          f"each W8A8 kernel runs int8 wgmma: {ops}")
    gen = torch.Generator(device=dev).manual_seed(6)
    b, k, n = DYN_HEADLINE
    x = torch.randn(b, k, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int16).to(torch.int8)
    scale = torch.rand(n, generator=gen, device=dev)
    mm.int8_matmul_dyn(x, q, scale)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    out = mm.int8_matmul_dyn(x, q, scale)
    torch.cuda.synchronize()
    allocated = torch.cuda.max_memory_allocated(dev) - held
    check(allocated == -(-out.numel() * 2 // 512) * 512, f"int8_matmul_dyn allocated {allocated} bytes, not only its "
          f"output's {out.numel() * 2}")
    phase("int8_matmul_dyn_build", gmma_ops=ops, call_allocates_bytes=allocated, output_bytes=out.numel() * 2)
    del x, q, out

    rows, headline = [], None
    for k, n in INT8_SHAPES:
        copies = max(2, -(-2 * L2_BYTES // (k * n)))
        qs = [torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int16).to(torch.int8)
              for _ in range(copies)]
        scale = torch.rand(n, generator=gen, device=dev) * 0.01 + 1e-4
        for b in DYN_ROWS:
            x = (3 * torch.randn(b, k, generator=gen, device=dev)).to(torch.bfloat16)
            x[-1] = x[0]
            got = mm.int8_matmul_dyn(x, qs[0], scale)
            want = mm.int8_matmul_dyn_reference(x, qs[0], scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(got.shape == want.shape and torch.equal(got, want),
                  f"int8_matmul_dyn B={b} K={k} N={n}: not bit-equal to the plain version (|d|={err})")
            check(torch.equal(got[-1], got[0]), f"int8_matmul_dyn B={b} K={k} N={n}: duplicated row differs")

            def plain(i):
                mm.int8_matmul_dyn_reference(x, qs[i % copies], scale)

            def kernel(i):
                mm.int8_matmul_dyn(x, qs[i % copies], scale)

            def w8a16(i):
                mm.int8_matmul(x, qs[i % copies], scale)

            times = [device_ms(f, 2 * copies) for f in (plain, kernel, w8a16, w8a16, kernel, plain)]
            ms, plain_ms, w8a16_ms = (times[1] + times[4]) / 2, (times[0] + times[5]) / 2, (times[2] + times[3]) / 2
            bound_ms, bound_by = gemv_bound(b, k, n, k * n, INT8_OPS)
            row = dict(B=b, K=k, N=n, max_abs_err=err, ms=ms, plain_ms=plain_ms, w8a16_ms=w8a16_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=_int_mm_ms(x, qs, scale) if b > 16 else None,
                       kernel_GBps=k * n / (ms * 1e-3) / 1e9, plan=wo.device_plan(b, k, n, 1, dev, wo.W8A8).describe(),
                       duplicate_row_bitwise_equal=True)
            phase("int8_matmul_dyn", **row)
            rows.append(row)
            if (b, k, n) == DYN_HEADLINE:
                headline = row
        del qs
    check(headline is not None, "int8_matmul_dyn headline shape measured")
    return {"max_abs_err": 0.0, **{key: headline[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                                   "library_ms")}, "rows": rows}


def w8a8_microbench_phase(dev: torch.device, dyn_rows: list[dict]) -> dict:
    """The port of ``scripts/microbench_w8a8.py``: the W8A8 error against an
    f32 product at 16 rows x 2048 x 8192, then its mix (per step and layer,
    seven linears of SmolLM2-1.7B's widths, 24 layers, 8 steps, 16 rows, the
    8192-wide input tiled from the 2048-wide one) captured as one CUDA graph,
    through the W8A8 kernel and through the W8A16 kernel, in turns; GB/s of
    int8 weights read.  Returns the kernel's row of ``int8_dyn_phase`` at
    the microbenchmark's 16 x 2048 x 8192 for the JSON line (its library
    call is null: ``torch._int_mm`` takes more than 16 rows)."""
    from s2s_tpu_torch.ops import int8_matmul as mm

    b, d, ff, layers, steps = 16, 2048, 8192, 24, 8
    gen = torch.Generator(device=dev).manual_seed(8)

    def stack(k, n):
        q = torch.randint(-127, 127, (layers, k, n), generator=gen, device=dev, dtype=torch.int16).to(torch.int8)
        return q, torch.full((layers, n), 0.01, device=dev)

    x = torch.randn(b, d, generator=gen, device=dev).to(torch.bfloat16)
    q, s = stack(d, ff)
    ref = x.float() @ (q[0].float() * s[0][None, :])
    got = mm.int8_matmul_dyn(x, q[0], s[0]).float()
    rel = (torch.linalg.norm(got - ref) / torch.linalg.norm(ref)).item()
    seven = [(d, d), (d, d), (d, d), (d, d), (d, ff), (d, ff), (ff, d)]
    weights = [stack(k, n) for k, n in seven]
    h0 = torch.ones(b, d, dtype=torch.bfloat16, device=dev)

    def mix(matmul):
        def run(_):
            h = h0
            for _ in range(steps):
                for layer in range(layers):
                    outs = []
                    for qq, ss in weights:
                        hi = h if qq.shape[1] == d else h.repeat(1, qq.shape[1] // d)
                        outs.append(matmul(hi, qq[layer], ss[layer])[:, :d])
                    h = sum(outs)
        return run

    times = [device_ms(mix(f), 1) for f in (mm.int8_matmul_dyn, mm.int8_matmul, mm.int8_matmul, mm.int8_matmul_dyn)]
    w8a8_s, w8a16_s = (times[0] + times[3]) / 2e3, (times[1] + times[2]) / 2e3
    nbytes = sum(k * n for k, n in seven) * layers * steps
    phase("w8a8_microbench", w8a8_rel_err_vs_f32=rel, seven_calls_w8a8_s=w8a8_s,
          seven_calls_w8a8_gbps=nbytes / w8a8_s / 1e9, seven_calls_w8a16_s=w8a16_s,
          seven_calls_w8a16_gbps=nbytes / w8a16_s / 1e9, weight_bytes=nbytes, calls=7 * layers * steps)
    check(math.isfinite(rel) and rel < 0.05, f"W8A8 error against f32 {rel}")
    return next(row for row in dyn_rows if (row["B"], row["K"], row["N"]) == (b, d, ff))


def tiny_quant_parity_phase(dev: torch.device) -> None:
    """The tiny f32 decoder LM and Qwen3-TTS under each new mode, every
    matrix quantized, on the card against the same code on the CPU: greedy
    tokens and codes equal, audio within 1e-4 relative."""
    from s2s_tpu_torch.models import decoder_lm, qwen3_tts
    from s2s_tpu_torch.ops.quant import quantize_tree
    from s2s_tpu_torch.weights import tree_to_torch as to

    cfg = decoder_lm.DecoderLMConfig.tiny()
    base = decoder_lm.init_params(cfg, torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(1, 256, (1, 16)).astype(np.int32))
    result = {}
    for mode, args in (("int8-dyn", dict(act_quant=True)), ("int4", dict(bits=4))):
        cpu = quantize_tree(base, min_size=1, **args)
        out = {}
        for label, device, params in (("cpu", "cpu", cpu), ("cuda", dev, to(cpu, dev))):
            state = decoder_lm.init_decode_state(cfg, 1, max_t=40, device=device)
            logits, state = decoder_lm.prefill(params, cfg, tokens.to(device), state, 13)
            toks, _, _, _ = decoder_lm.decode_chunk(params, cfg, logits.argmax(-1).to(torch.int32), state, 16, -1)
            out[label] = (logits.cpu(), toks.cpu())
        rel = ((out["cpu"][0] - out["cuda"][0]).abs().max() / out["cpu"][0].abs().max()).item()
        check(rel <= 1e-4, f"decoder_lm {mode} logits cuda vs cpu rel {rel}")
        check(torch.equal(out["cpu"][1], out["cuda"][1]), f"decoder_lm {mode} greedy tokens cuda vs cpu")
        result[f"lm_{mode}_logits_rel_err"] = rel

    qcfg = qwen3_tts.Qwen3TTSConfig.tiny()
    qbase = qwen3_tts.init_params(qcfg, torch.Generator().manual_seed(3))
    for mode, args in (("int8-dyn", dict(act_quant=True)), ("int8+cp4", dict(cp_bits=4)),
                       ("int4", dict(talker_bits=4, cp_bits=4))):
        qcpu = qwen3_tts.quantize_params(qbase, min_size=1, **args)
        chunks = {}
        for label, device, params in (("cpu", "cpu", qcpu), ("cuda", dev, to(qcpu, dev))):
            model = qwen3_tts.Qwen3TTS(params=params, cfg=qcfg, chunk_frames=3, device=device)
            chunks[label] = [a for a, _ in model.stream("Hello there.", max_new_tokens=9)]
        check([len(a) for a in chunks["cpu"]] == [len(a) for a in chunks["cuda"]], f"qwen3 {mode} chunk lengths")
        ref = np.concatenate(chunks["cpu"])
        rel = float(np.abs(ref - np.concatenate(chunks["cuda"])).max() / max(np.abs(ref).max(), 1e-12))
        check(rel <= 1e-4, f"qwen3 {mode} audio cuda vs cpu rel {rel}")
        result[f"qwen3_{mode}_audio_rel_err"] = rel
    phase("tiny_quant_parity", **result)


def _launch_counters():
    from s2s_tpu_torch.ops import decode_attention as da
    from s2s_tpu_torch.ops import int4_matmul as m4
    from s2s_tpu_torch.ops import int8_matmul as mm

    from s2s_tpu_torch.ops import flash_attention as fa
    from s2s_tpu_torch.ops import log_mel

    return {"int8_matmul": mm.int8_matmul, "decode_attention": da.concat_attention,
            "int8_matmul_dyn": mm.int8_matmul_dyn, "int4_matmul": m4.int4_matmul,
            "flash_attention": fa.flash_attention, "log_mel": log_mel.log_mel_spectrogram,
            "parakeet_log_mel": log_mel.parakeet_log_mel}


@contextlib.contextmanager
def counted_transcriptions():
    """Counts Parakeet's transcription batches (``transcribe_step_batch``,
    through which the single-session and the batched STT both go) in the
    dict it yields, under "batches"."""
    from s2s_tpu_torch.models import parakeet

    seen = {"batches": 0}
    real = parakeet.transcribe_step_batch

    def counted(*args, **kwargs):
        seen["batches"] += 1
        return real(*args, **kwargs)

    parakeet.transcribe_step_batch = counted
    try:
        yield seen
    finally:
        parakeet.transcribe_step_batch = real


def check_parakeet_frontend(launches: int, batches: int, where: str) -> None:
    check(launches > 0 and launches == batches,
          f"{where}: the Parakeet frontend's log-mel launched {launches} times for {batches} transcription "
          f"batches (one a batch, > 0)")


def _by_rows_counters():
    from s2s_tpu_torch.ops import int4_matmul as m4
    from s2s_tpu_torch.ops import int8_matmul as mm

    return (mm.int8_matmul, mm.int8_matmul_dyn, m4.int4_matmul)


def _launches_by_rows() -> dict[str, dict[int, int]]:
    """The int8, W8A8 and int4 kernels' launches since their row counts were
    cleared, by the rows of the call."""
    return {fn.__name__: dict(sorted(fn.rows.items())) for fn in _by_rows_counters()}


def quant_serve_phase(dev: torch.device, card: list[str]) -> dict[str, int]:
    """The 8-session batched serve (``QUANT_SERVE_FLAGS``) with
    ``--llm_quantize int8-dyn --tts_quantize int8+cp4``: build (engines
    warmed), then one concurrent round of 8 text turns.  Every count is set
    to 0 just before the build and read after the warm-up and after the
    round; returns the counts over the whole serve.  With 8 slots the LM's
    steady steps have 8 rows and take the W8A8 kernel (so do the warm-up's
    16-, 32- and 64-token prompt buckets)."""
    from s2s_tpu_torch import builder, cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    counters = _launch_counters()
    warm = {}
    untimed = builder.warmup_engines

    def timed_warmup():
        torch.cuda.synchronize()
        t = time.perf_counter()
        untimed()
        torch.cuda.synchronize()
        warm["s"] = time.perf_counter() - t
        warm["launches"] = {name: fn.launches for name, fn in counters.items()}

    builder.warmup_engines = timed_warmup
    stop = threading.Event()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        manager, server, _ = cli.build_from_argv(["--device", "cuda", *QUANT_SERVE_FLAGS], stop)
    finally:
        builder.warmup_engines = untimed
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0 - warm.get("s", 0.0)
    check("s" in warm, "--warmup_engines warmed the batched engines")
    manager.start()
    try:
        check(server.started.wait(60), "server started")
        url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"
        before = {name: fn.launches for name, fn in counters.items()}
        for fn in _by_rows_counters():
            fn.rows.clear()
        t0 = time.perf_counter()
        rounds = asyncio.run(_concurrent_text_turns(url, QUANT_SESSIONS))
        round_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        by_rows = _launches_by_rows()
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()

    sessions = []
    for i, events in enumerate(rounds):
        pcm, done = _reply(events, f"quantized concurrent text turn {i}")
        sessions.append({"ttfa_s": _first_audio_s(events), "turn_s": done, "audio_seconds": pcm.size / 24_000})
    in_round = {name: launches[name] - before[name] for name in launches}
    check(launches["int8_matmul_dyn"] > 0 and launches["int4_matmul"] > 0,
          f"the W8A8 and int4 kernels launched in the quantized serve: {launches}")
    check(in_round["int8_matmul_dyn"] > 0 and in_round["int4_matmul"] > 0,
          f"the W8A8 and int4 kernels launched in the quantized round: {in_round}")
    phase("quant_serve", card=card, sessions=QUANT_SESSIONS, flags=QUANT_SERVE_FLAGS[len(BATCHED_FLAGS):],
          build_s=build_s, warmup_s=warm["s"], round_s=round_s, text_turns=sessions, launches=launches, launches_warmup=warm["launches"],
          launches_round=in_round, launches_round_by_rows=by_rows)
    return launches


async def _session(url: str, actions, until, max_s: float):
    """Connect, send *actions* ((delay_s, event) pairs), collect
    (seconds since the first action, event) until *until(events, now)*
    holds; fail after *max_s*."""
    import websockets.asyncio.client as ws_client

    events: list[tuple[float, dict]] = []
    for _ in range(240):  # the one pipeline slot frees once the last session drained
        ws = await ws_client.connect(url, max_size=None)
        first = json.loads(await asyncio.wait_for(ws.recv(), 30))
        if first.get("type") == "session.created":
            break
        await ws.close()
        await asyncio.sleep(0.25)
    check(first.get("type") == "session.created", f"first event {first}")
    async with ws:
        t0 = time.perf_counter()
        for delay, event in actions:
            await asyncio.sleep(delay)
            await ws.send(json.dumps(event))
        while not until(events, time.perf_counter() - t0):
            check(time.perf_counter() - t0 < max_s,
                  f"turn did not finish in {max_s} s; got {[e['type'] for _, e in events][-20:]}")
            try:
                msg = await asyncio.wait_for(ws.recv(), 1.0)
            except asyncio.TimeoutError:
                continue  # re-check the condition and the deadline
            events.append((time.perf_counter() - t0, json.loads(msg)))
    return events


def _text_turn(text: str):
    return [
        (0, {"type": "conversation.item.create", "item": {
            "type": "message", "role": "user", "content": [{"type": "input_text", "text": text}]}}),
        (0, {"type": "response.create", "response": {}}),
    ]


def _audio_turn(freq: float = 220.0):
    rate = 16_000
    t = np.arange(2 * rate) / rate
    speech = 0.3 * np.sin(2 * np.pi * freq * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    pcm = np.concatenate([np.zeros(rate // 4), speech, np.zeros(rate)])
    pcm16 = (np.clip(pcm, -1, 1) * 32767).astype(np.int16).tobytes()
    step = rate // 10 * 2  # 100 ms of PCM16 per append
    appends = [(0.0, {"type": "input_audio_buffer.append",
                      "audio": base64.b64encode(pcm16[i : i + step]).decode()})
               for i in range(0, len(pcm16), step)]
    return appends + [(0.0, {"type": "input_audio_buffer.commit"})]


def _types(events) -> list[str]:
    return [e["type"] for _, e in events]


def _response_done(events, now) -> bool:
    return "response.done" in _types(events)


def _transcripts(events) -> list[tuple[float, str]]:
    return [(t, e["transcript"]) for t, e in events
            if e["type"] == "conversation.item.input_audio_transcription.completed"]


def _transcribed_and_settled(events, now) -> bool:
    """The audio turn: a transcription event, then the reply's
    ``response.done``; an empty random-init transcript starts no reply, so
    then 5 s of quiet end the turn.  (A VAD-driven reply may carry no
    ``response.created``: the shared realtime handlers open it silently on
    its first text.)"""
    transcripts = _transcripts(events)
    if not transcripts:
        return False
    if transcripts[0][1].strip():
        return "response.done" in _types(events)
    return now - transcripts[0][0] > 5.0


def serve_phase(dev: torch.device) -> dict[str, int]:
    """The single-session serve: a warm-up text turn, then a measured text
    turn and a voice turn; returns the int8 kernel's and the Parakeet
    frontend's launches over those."""
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.ops import int8_matmul as mm
    from s2s_tpu_torch.ops import log_mel
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    stop = threading.Event()
    t0 = time.perf_counter()
    manager, server, _ = cli.build_from_argv(["--device", "cuda", *FULL_FLAGS], stop)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    manager.start()
    try:
        check(server.started.wait(60), "server started")
        url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"
        t0 = time.perf_counter()
        asyncio.run(_session(url, _text_turn("Warm up, please."), _response_done, 600))
        warmup_s = time.perf_counter() - t0

        with counted_transcriptions() as stt:
            mm.int8_matmul.launches = log_mel.parakeet_log_mel.launches = 0  # count the measured turns only
            text = asyncio.run(_session(url, _text_turn(TEXT), _response_done, 600))
            audio = asyncio.run(_session(url, _audio_turn(), _transcribed_and_settled, 600))
            torch.cuda.synchronize()
            launches, mel_launches = mm.int8_matmul.launches, log_mel.parakeet_log_mel.launches
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()

    text_pcm, text_done = _reply(text, "text turn")
    voice = _voice_summary(audio)
    check(launches > 0, "int8 kernel launched during the turns")
    check_parakeet_frontend(mel_launches, stt["batches"], "single-session serve")
    phase("serve", build_s=build_s, warmup_turn_s=warmup_s, ttfa_s=_first_audio_s(text), text_turn_s=text_done,
          audio_seconds=text_pcm.size / 24_000, voice_turn=voice, int8_launches=launches,
          parakeet_log_mel_launches=mel_launches, transcription_batches=stt["batches"])
    return {"int8_matmul": launches, "parakeet_log_mel": mel_launches}


def _reply_or_quiet(events, now) -> bool:
    """A voice turn of the Whisper serve: its transcription, then either the
    reply's ``response.done`` or, if no reply audio has come 20 s after the
    transcription, the end of the attempt."""
    transcripts = _transcripts(events)
    if not transcripts:
        return False
    if "response.output_audio.delta" in _types(events):
        return "response.done" in _types(events)
    return now - transcripts[0][0] > 20.0


def _voice_summary(events) -> dict:
    transcripts = _transcripts(events)
    check(len(transcripts) >= 1, "audio turn transcription event")
    voice = {"transcript": transcripts[0][1][:80], "transcription_s": transcripts[0][0]}
    if transcripts[0][1].strip():
        voice_pcm, voice_done = _reply(events, "audio turn")
        voice.update(first_audio_s=_first_audio_s(events), reply_audio_seconds=voice_pcm.size / 24_000,
                     done_s=voice_done)
    return voice


async def _concurrent_text_turns(url: str, n: int):
    return await asyncio.gather(*(_session(url, _text_turn(f"{TEXT} Session {i}."), _response_done, 900)
                                  for i in range(n)))


def batched_serve_phase(dev: torch.device, card: list[str]) -> dict[str, int]:
    """The 4-session batched serve: build (engines warmed), four concurrent
    text turns, one voice turn, then a traced concurrent round; returns each
    kernel's launches over the measured turns.  *card* (``nvidia-smi`` name
    and power limit) is printed with the times."""
    from s2s_tpu_torch import builder, cli
    from s2s_tpu_torch.ops import decode_attention as da
    from s2s_tpu_torch.ops import int4_matmul as m4
    from s2s_tpu_torch.ops import int8_matmul as mm
    from s2s_tpu_torch.ops import log_mel
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    warm = {}
    untimed = builder.warmup_engines

    def timed_warmup():
        torch.cuda.synchronize()  # the weights' init kernels count to the build
        t = time.perf_counter()
        untimed()
        warm["s"] = time.perf_counter() - t

    builder.warmup_engines = timed_warmup
    stop = threading.Event()
    t0 = time.perf_counter()
    try:
        manager, server, _ = cli.build_from_argv(["--device", "cuda", *BATCHED_FLAGS], stop)
    finally:
        builder.warmup_engines = untimed
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0 - warm.get("s", 0.0)
    check("s" in warm, "--warmup_engines warmed the batched engines")
    manager.start()
    try:
        check(server.started.wait(60), "server started")
        url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"
        with counted_transcriptions() as stt:
            # count the measured turns only
            mm.int8_matmul.launches = da.concat_attention.launches = log_mel.parakeet_log_mel.launches = 0
            mm.int8_matmul.rows.clear()
            m4.int4_matmul.rows.clear()
            t0 = time.perf_counter()
            rounds = asyncio.run(_concurrent_text_turns(url, SESSIONS))
            round_s = time.perf_counter() - t0
            audio = asyncio.run(_session(url, _audio_turn(), _transcribed_and_settled, 600))
            torch.cuda.synchronize()
            launches = {"int8_matmul": mm.int8_matmul.launches, "decode_attention": da.concat_attention.launches}
            mel_launches = log_mel.parakeet_log_mel.launches
            by_rows = _launches_by_rows()
        trace = traced_round(url)
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()

    sessions = []
    for i, events in enumerate(rounds):
        pcm, done = _reply(events, f"concurrent text turn {i}")
        sessions.append({"ttfa_s": _first_audio_s(events), "turn_s": done, "audio_seconds": pcm.size / 24_000})
    voice = _voice_summary(audio)
    check(all(v > 0 for v in launches.values()), f"both kernels launched in the batched serve: {launches}")
    check_parakeet_frontend(mel_launches, stt["batches"], "batched serve")
    launches["parakeet_log_mel"] = mel_launches
    phase("batched_serve", card=card, sessions=SESSIONS, build_s=build_s, warmup_s=warm["s"], round_s=round_s,
          text_turns=sessions, voice_turn=voice, launches=launches, launches_by_rows=by_rows,
          transcription_batches=stt["batches"])
    phase("trace", **trace)
    return launches


def traced_round(url: str) -> dict:
    """One more concurrent round under ``torch.profiler``, device activity
    only.  The busy share is over the span from the round's first kernel to
    its last (the union of device intervals, so overlap counts once)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rounds = asyncio.run(_concurrent_text_turns(url, SESSIONS))
        torch.cuda.synchronize()
    replies = [_reply(events, f"traced turn {i}") for i, events in enumerate(rounds)]
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    check(len(device) > 0, "torch.profiler recorded device activity")
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in device)
    busy_ns, end = 0, spans[0][0]
    for start, stop in spans:
        busy_ns += max(0, stop - max(start, end))
        end = max(end, stop)
    span_s = (end - spans[0][0]) / 1e9
    by_name: dict[str, list] = {}
    for e in device:
        entry = by_name.setdefault(e.name()[:60], [0, 0])
        entry[0] += e.duration_ns()
        entry[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    ours = {name: {"device_ms": ns / 1e6, "calls": n} for name, (ns, n) in by_name.items()
            if any(k in name for k in ("decode_attention_kernel", "weight_only_gemv_kernel", "weight_only_tc_kernel"))}
    return {"sessions": SESSIONS, "done_s": [d for _, d in replies],
            "audio_seconds": [pcm.size / 24_000 for pcm, _ in replies], "span_s": span_s,
            "device_busy_s": busy_ns / 1e9, "device_busy_share": busy_ns / 1e9 / span_s,
            "device_ops": len(device),
            "top": [{"name": name, "device_ms": ns / 1e6, "calls": n} for name, (ns, n) in top],
            "port_kernels": ours}


def flash_attention_phase(dev: torch.device) -> dict:
    """``flash_attention`` against its plain version at ``FLASH_SHAPES`` in
    bf16, q, k and v laid out as the encoder makes them ((B, T, H, D)
    projections viewed as heads); device times of the kernel, the plain
    version and ``F.scaled_dot_product_attention`` (the library yardstick,
    never called by the port).  The inputs stay in L2 between calls, as the
    encoder's projections do."""
    from s2s_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(9)
    rows, max_err, headline, d, calls = [], 0.0, None, 64, 20
    for name, h, t, causal in FLASH_SHAPES:
        q, k, v = (torch.randn(1, t, h, d, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
                   for _ in range(3))
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 * bf16_ulp(want.float().abs().max().item())
        check(got.shape == want.shape and math.isfinite(err) and err <= tol,
              f"flash_attention {name} H={h} T={t} causal={causal}: |d|={err} > {tol}")
        max_err = max(max_err, err)
        dup = fa.flash_attention(*(torch.cat([x, x[:, :1]], dim=1) for x in (q, k, v)), causal=causal)
        torch.cuda.synchronize()
        check(torch.equal(dup[:, h], dup[:, 0]), f"flash_attention {name} H={h} T={t}: a duplicated head differs")

        def plain(i):
            fa.flash_attention_reference(q, k, v, causal=causal)

        def kernel(i):
            fa.flash_attention(q, k, v, causal=causal)

        def library(i):
            torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)

        times = [device_ms(f, calls) for f in (plain, kernel, kernel, plain)]
        ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
        pairs = t * (t + 1) // 2 if causal else t * t
        # q, k, v read once and o written once (bf16); QK^T and PV over the unmasked pairs
        bound_ms, bound_by = bound(4 * h * t * d * 2, 4 * h * pairs * d, BF16_FLOPS)
        row = dict(shape=name, H=h, T=t, D=d, causal=causal, max_abs_err=err, bound=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=device_ms(library, calls), bound_ms=bound_ms, bound_by=bound_by,
                   kernel_TFLOPs=4 * h * pairs * d / (ms * 1e-3) / 1e12, duplicate_head_bitwise_equal=True,
                   **fa.tensor_core_tiles())
        phase("flash_attention", **row)
        rows.append(row)
        if (name, h, t, causal) == FLASH_HEADLINE:
            headline = row
    check(headline is not None, "flash_attention headline shape measured")
    return {"max_abs_err": max_err, **{key: headline[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                                       "library_ms")}}


def _speech_like(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Noise under a 220 Hz tone modulated at 3 Hz, f32 at 16 kHz."""
    t = torch.arange(n, device=dev) / 16_000
    tone = 0.3 * torch.sin(2 * math.pi * 220 * t) * (1 + 0.5 * torch.sin(2 * math.pi * 3 * t))
    return (0.1 * torch.randn(n, generator=gen, device=dev) + tone).float()


def log_mel_phase(dev: torch.device) -> dict:
    """The log-mel through the kernel (``log_mel.log_mel_spectrogram``, one
    launch) against the plain torch ops (``mel.log_mel_spectrogram``) at
    ``LOG_MEL_SHAPES``, within ``LOG_MEL_ATOL``, a second run bitwise equal;
    device times of both and of the library yardstick: ``torch.stft`` +
    power + filterbank product + the same log steps.  Then a grid one block
    larger than the card holds: refused, its output untouched.  Then
    Parakeet's frontend (``parakeet_log_mel_phase``)."""
    import dataclasses

    from s2s_tpu_torch.ops import log_mel, mel

    gen = torch.Generator(device=dev).manual_seed(11)
    rows, max_err, headline, calls = [], 0.0, None, 20
    window = torch.hann_window(mel.N_FFT, periodic=True, device=dev)
    for seconds, n_mels in LOG_MEL_SHAPES:
        audio = _speech_like(seconds * 16_000, gen, dev)
        before = log_mel.log_mel_spectrogram.launches
        got = log_mel.log_mel_spectrogram(audio, n_mels)
        again = log_mel.log_mel_spectrogram(audio, n_mels)
        launched = log_mel.log_mel_spectrogram.launches - before
        want = mel.log_mel_spectrogram(audio, n_mels)
        fb = mel.tables(n_mels, dev)[2]

        def library(i=0):
            spec = torch.stft(audio, mel.N_FFT, mel.HOP_LENGTH, window=window, center=True, pad_mode="reflect",
                              return_complex=True)
            power = (spec.real * spec.real + spec.imag * spec.imag)[:, :-1]
            return mel.log_scale(power.T @ fb)

        lib_diff = (library() - want).abs().max().item()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(got.shape == want.shape == (n_mels, seconds * 100) and math.isfinite(err) and err <= LOG_MEL_ATOL,
              f"log_mel {seconds} s x {n_mels}: |d|={err} > {LOG_MEL_ATOL}")
        check(torch.equal(got, again), f"log_mel {seconds} s x {n_mels}: two runs differ")
        check(launched == 2, f"log_mel {seconds} s x {n_mels}: {launched} launches for two calls")
        max_err = max(max_err, err)

        def plain(i):
            mel.log_mel_spectrogram(audio, n_mels)

        def kernel(i):
            log_mel.log_mel_spectrogram(audio, n_mels)

        times = [device_ms(f, calls) for f in (plain, kernel, kernel, plain)]
        ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
        frames, n_fft, n_freqs = seconds * 100, mel.N_FFT, mel.N_FREQS
        # the function's own minimum: the audio read once and the log-mel
        # written once; per frame a real FFT (2.5 n log2 n flops), the power
        # (3 per bin) and the filterbank's nonzero weights (2 each)
        nnz = int(torch.count_nonzero(fb).item())
        fft_flops = frames * (2.5 * n_fft * math.log2(n_fft) + 3 * n_freqs + 2 * nnz)
        bound_ms, bound_by = bound(4 * (seconds * 16_000 + frames * n_mels), fft_flops, F32_FLOPS)
        # for information: the earlier direct-DFT design's work (2 flops per
        # sample, bin and frame for each of re and im) with the bases and the
        # filterbank read once
        dft_bytes = 4 * (seconds * 16_000 + 2 * n_fft * n_freqs + n_freqs * n_mels + frames * n_mels)
        direct_dft_bound_ms = bound(dft_bytes, frames * (4 * n_fft * n_freqs + 3 * n_freqs + 2 * nnz),
                                    F32_FLOPS)[0]
        row = dict(seconds=seconds, n_mels=n_mels, max_abs_err=err, atol=LOG_MEL_ATOL, ms=ms, plain_ms=plain_ms,
                   kernel_only_ms=ms, library_ms=device_ms(library, calls), library_max_abs_diff=lib_diff,
                   bound_ms=bound_ms, bound_by=bound_by, direct_dft_bound_ms=direct_dft_bound_ms,
                   repeat_bitwise_equal=True, launches_per_call=launched // 2,
                   plan=log_mel.device_plan(False, 1, audio.shape[0], n_mels, dev, n_fft).describe())
        phase("log_mel", **row)
        rows.append(row)
        if (seconds, n_mels) == LOG_MEL_HEADLINE:
            headline = row
    check(headline is not None, "log_mel headline shape measured")

    # a grid one block past what the card holds at once is refused unrun
    audio = _speech_like(8 * 16_000, gen, dev)
    plan = log_mel.device_plan(False, 1, audio.shape[0], 80, dev, mel.N_FFT)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    big = dataclasses.replace(plan, grid=plan.blocks_per_sm * sms + 1)
    out = torch.full((80, 800), float("nan"), device=dev)
    try:
        log_mel._launch(False, audio[None], None, out, None, log_mel._tables("whisper", mel.N_FFT, mel.N_FFT, 80, dev),
                        mel.N_FFT, mel.HOP_LENGTH, 80, 0.0, big)
        refused = None
    except RuntimeError as exc:
        refused = str(exc)[:160]
    torch.cuda.synchronize()
    check(refused is not None and bool(torch.isnan(out).all()), f"an oversize cooperative grid ({big.grid} blocks) "
          f"was refused and left its output untouched: {refused}")
    phase("log_mel_oversize_grid", grid=big.grid, refused=refused)
    return {"max_abs_err": max_err, **{key: headline[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                                       "library_ms")},
            "parakeet": parakeet_log_mel_phase(dev, gen)}


def parakeet_log_mel_phase(dev: torch.device, gen: torch.Generator) -> dict:
    """Parakeet's batched frontend through the kernel (``parakeet_log_mel``,
    one launch a batch) against its plain batched version at
    ``PARAKEET_MEL_SHAPES``: rows of differing n_valid, at widths over 1 a
    padding row (n_valid 0) that must come out exactly zero, within
    ``PARAKEET_MEL_RTOL`` x max|plain|, a second run bitwise equal; device
    times of the kernel, the plain batched version, the per-row plain loop
    the port ran before (``models.parakeet.log_mel_frontend`` a row) and the
    library yardstick: ``torch.stft`` (n_fft 512, hop 160, a symmetric
    hann(400), constant padding) + power + filterbank + log + the masked
    normalization.  Returns the headline row with the phase's largest
    relative error."""
    from s2s_tpu_torch.models import parakeet
    from s2s_tpu_torch.ops import log_mel, mel

    cfg = parakeet.ParakeetConfig()
    fe = parakeet.frontend(cfg)
    cos_b, sin_b, fb = log_mel.stft_tables(fe, dev)
    window = torch.hann_window(fe.win_length, periodic=False, device=dev)
    nnz = int(torch.count_nonzero(fb).item())
    n_freqs = fe.n_fft // 2 + 1
    max_rel, headline, calls = 0.0, None, 10
    for width, seconds in PARAKEET_MEL_SHAPES:
        n = seconds * 16_000
        audio = torch.stack([_speech_like(n, gen, dev) for _ in range(width)])
        n_valid = [n - (i * n) // (2 * width) for i in range(width)]
        if width > 1:
            n_valid[-1] = 0
        for i, nv in enumerate(n_valid):
            audio[i, nv:] = 0.0
        nv_t = torch.tensor(n_valid, dtype=torch.int32, device=dev)
        before = log_mel.parakeet_log_mel.launches
        got, frames = log_mel.parakeet_log_mel(audio, nv_t, fe)
        again, _ = log_mel.parakeet_log_mel(audio, nv_t, fe)
        launched = log_mel.parakeet_log_mel.launches - before
        want, want_frames = log_mel.parakeet_log_mel_reference(audio, nv_t, fe)

        def library(i=0):
            x = torch.cat([audio[:, :1], audio[:, 1:] - fe.preemphasis * audio[:, :-1]], dim=1)
            x = torch.where(torch.arange(n, device=dev)[None, :] < nv_t[:, None], x, 0.0)
            spec = torch.stft(x, fe.n_fft, fe.hop, win_length=fe.win_length, window=window, center=True,
                              pad_mode="constant", return_complex=True)
            logmel = torch.log((spec.real * spec.real + spec.imag * spec.imag).transpose(1, 2) @ fb
                               + log_mel.LOG_ZERO_GUARD)
            valid = torch.div(nv_t, fe.hop, rounding_mode="floor")
            mask = (torch.arange(logmel.shape[1], device=dev)[None, :] < valid[:, None])[:, :, None]
            denom = torch.clamp_min(valid, 1).float()[:, None, None]
            mean = torch.where(mask, logmel, 0.0).sum(dim=1, keepdim=True) / denom
            var = torch.where(mask, (logmel - mean) ** 2, 0.0).sum(dim=1, keepdim=True)
            std = torch.sqrt(var / torch.clamp_min(denom - 1.0, 1.0))
            return torch.where(mask, (logmel - mean) / (std + log_mel.NORM_EPS), 0.0)

        lib_diff = (library() - want).abs().max().item()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = PARAKEET_MEL_RTOL * want.abs().max().item()
        where = f"parakeet_log_mel {width} x {seconds} s"
        check(got.shape == want.shape == (width, 1 + n // fe.hop, fe.n_mels) and math.isfinite(err) and err <= tol,
              f"{where}: |d|={err} > {tol}")
        check(torch.equal(frames, want_frames), f"{where}: valid frames {frames.tolist()}")
        check(torch.equal(got, again), f"{where}: two runs differ")
        check(launched == 2, f"{where}: {launched} launches for two calls")
        check(width == 1 or torch.count_nonzero(got[-1]).item() == 0, f"{where}: the padding row is not zero")
        max_rel = max(max_rel, err / want.abs().max().item())

        def plain(i):
            log_mel.parakeet_log_mel_reference(audio, nv_t, fe)

        def kernel(i):
            log_mel.parakeet_log_mel(audio, nv_t, fe)

        def row_loop(i):
            for r in range(width):
                parakeet.log_mel_frontend(audio[r], n_valid[r], cfg)

        times = [device_ms(f, calls) for f in (plain, kernel, row_loop, row_loop, kernel, plain)]
        ms, plain_ms, loop_ms = (times[1] + times[4]) / 2, (times[0] + times[5]) / 2, (times[2] + times[3]) / 2
        # the function's own minimum: audio and n_valid read once, features
        # and frames written once; per valid frame a real FFT, the power and
        # the filterbank's nonzero weights; per valid output the two passes
        # of the normalization (about 5 flops)
        valid_frames = sum(v // fe.hop for v in n_valid)
        flops = valid_frames * (2.5 * fe.n_fft * math.log2(fe.n_fft) + 3 * n_freqs + 2 * nnz + 5 * fe.n_mels)
        out_elems = width * (1 + n // fe.hop) * fe.n_mels
        bound_ms, bound_by = bound(4 * (width * n + 2 * width + out_elems), flops, F32_FLOPS)
        row = dict(rows=width, seconds=seconds, n_valid=n_valid, max_abs_err=err, rtol=PARAKEET_MEL_RTOL, bound=tol,
                   ms=ms, plain_ms=plain_ms, row_loop_ms=loop_ms, library_ms=device_ms(library, calls),
                   library_max_abs_diff=lib_diff, bound_ms=bound_ms, bound_by=bound_by,
                   padding_row_zero=width > 1, repeat_bitwise_equal=True, launches_per_call=launched // 2,
                   plan=log_mel.device_plan(True, width, n, fe.n_mels, dev, fe.n_fft, fe.hop).describe())
        phase("parakeet_log_mel", **row)
        if (width, seconds) == PARAKEET_MEL_HEADLINE:
            headline = row
    check(headline is not None, "parakeet_log_mel headline shape measured")
    return {**headline, "max_rel_err": max_rel}


def tiny_whisper_parity_phase(dev: torch.device) -> None:
    """Whisper ``test_tiny`` at head dim 64 (d 128, 2 heads, so the encoder's
    attention takes the flash kernel on the card), f32: log-mel, encoder
    and greedy tokens; Smart Turn's chain (``smart_turn.run``) on 8 s; the
    voice-clone speaker: on the card against the same code on the CPU."""
    import dataclasses

    from s2s_tpu_torch.models import qwen3_tts, whisper
    from s2s_tpu_torch.ops import flash_attention as fa
    from s2s_tpu_torch.ops import log_mel
    from s2s_tpu_torch.vad import smart_turn
    from s2s_tpu_torch.weights import tree_to_torch as to

    before = fa.flash_attention.launches, log_mel.log_mel_spectrogram.launches
    cfg = dataclasses.replace(whisper.WhisperConfig.test_tiny(), d_model=128, n_heads=2, n_audio_ctx=400)
    cpu = whisper.init_params(cfg, torch.Generator().manual_seed(12))
    cpu["head"] = {"w": torch.randn((128, 1), generator=torch.Generator().manual_seed(13)) * 0.3,
                   "b": torch.full((1,), 0.1)}
    audio = _speech_like(2 * 16_000, torch.Generator().manual_seed(14), "cpu")
    window = smart_turn.prepare_audio(audio.numpy())
    spk_proj = torch.randn((80, 96), generator=torch.Generator().manual_seed(15)) * 80 ** -0.5
    out = {}
    for label, device, params in (("cpu", "cpu", cpu), ("cuda", dev, to(cpu, dev))):
        mel = log_mel.log_mel_spectrogram(audio.to(device), 80)[None]
        enc = whisper.encode(params, cfg, mel)
        buf, n = whisper.greedy_decode_device(params, cfg, enc, torch.tensor([[1, 2, 3]], dtype=torch.int32,
                                                                             device=device), 16, 0)
        st_mel = log_mel.log_mel_spectrogram(torch.from_numpy(window).to(device), 80)[None]
        prob = float(smart_turn.run(params, cfg, st_mel))
        spk = qwen3_tts.speaker_from_reference({"spk_proj": spk_proj.to(device)}, audio.numpy())
        out[label] = (mel.cpu(), enc.cpu(), buf[:n].tolist(), prob, spk.cpu())
    mel_err = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
    check(mel_err <= LOG_MEL_ATOL, f"tiny whisper log-mel cuda vs cpu |d|={mel_err}")
    rel = ((out["cpu"][1] - out["cuda"][1]).abs().max() / out["cpu"][1].abs().max()).item()
    check(rel <= 1e-4, f"tiny whisper encoder cuda vs cpu rel {rel}")
    check(out["cpu"][2] == out["cuda"][2] and len(out["cpu"][2]) > 0, f"tiny whisper tokens {out['cpu'][2]} "
                                                                        f"vs {out['cuda'][2]}")
    prob_err = abs(out["cpu"][3] - out["cuda"][3])
    check(prob_err <= 1e-4, f"smart turn probability cuda vs cpu |d|={prob_err}")
    spk_rel = ((out["cpu"][4] - out["cuda"][4]).abs().max() / out["cpu"][4].abs().max()).item()
    check(spk_rel <= 1e-4, f"speaker_from_reference cuda vs cpu rel {spk_rel}")
    launches = fa.flash_attention.launches - before[0], log_mel.log_mel_spectrogram.launches - before[1]
    check(launches[0] == 2 * cfg.n_enc_layers and launches[1] == 3,
          f"the tiny path launched flash {launches[0]} (want {2 * cfg.n_enc_layers}), log-mel {launches[1]} (want 3)")
    phase("tiny_whisper_parity", log_mel_abs_err=mel_err, encoder_rel_err=rel, tokens=len(out["cpu"][2]),
          smart_turn_prob_abs_err=prob_err, speaker_rel_err=spk_rel, flash_launches=launches[0],
          log_mel_launches=launches[1])


class _Lines(logging.Handler):
    """Keeps the log records it is handed."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.records: list[logging.LogRecord] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)


def whisper_serve_phase(dev: torch.device, card: list[str]) -> dict[str, int]:
    """The single-session serve with Whisper distil-large-v3 and Smart Turn
    (``WHISPER_FLAGS``): build (the STT handler warms Whisper up), then every
    count set to 0, one text turn and the voice turns.  Smart Turn's predictions and
    the Whisper and Smart Turn encodes are counted by wrapping
    ``SmartTurnAnalyzer.predict`` and ``whisper.encode``; the VAD handler
    would log a failed prediction and carry on, so failures are counted and
    its log watched.  Returns each kernel's launches over the two turns."""
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.models import whisper
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE
    from s2s_tpu_torch.vad import smart_turn

    counters = _launch_counters()
    encodes = {"whisper": 0, "smart_turn": 0}
    predictions, failures = [], []
    real_encode, real_predict = whisper.encode, smart_turn.SmartTurnAnalyzer.predict

    def counted_encode(params, cfg, mel):
        encodes["whisper" if cfg.n_enc_layers == WHISPER_LAYERS else "smart_turn"] += 1
        return real_encode(params, cfg, mel)

    def counted_predict(self, audio, sample_rate=smart_turn.SAMPLE_RATE):
        try:
            result = real_predict(self, audio, sample_rate)
        except Exception as exc:
            failures.append(repr(exc))
            raise
        predictions.append(result)
        return result

    lines = _Lines()
    loggers = [logging.getLogger(n) for n in ("s2s_tpu_torch.vad.handler", "s2s_tpu_torch.stt.whisper_handler")]
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.addHandler(lines)
        lg.setLevel(logging.INFO)
    whisper.encode = counted_encode
    smart_turn.SmartTurnAnalyzer.predict = counted_predict
    stop = threading.Event()
    try:
        t0 = time.perf_counter()
        manager, server, _ = cli.build_from_argv(["--device", "cuda", *WHISPER_FLAGS], stop)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        manager.start()
        try:
            check(server.started.wait(60), "server started")
            url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"
            torch.cuda.synchronize()
            for fn in counters.values():  # count the measured turns only (not the build's warm-up)
                fn.launches = 0
            encodes.update(whisper=0, smart_turn=0)
            predictions.clear()
            lines.records.clear()
            text = asyncio.run(_session(url, _text_turn(TEXT), _response_done, 600))
            attempts, audio = [], None
            for tone in VOICE_TONES_HZ:
                events = asyncio.run(_session(url, _audio_turn(tone), _reply_or_quiet, 300))
                transcripts = _transcripts(events)
                check(len(transcripts) >= 1 and transcripts[0][1].strip() != "",
                      f"whisper serve voice turn at {tone} Hz: a non-empty transcription ({transcripts})")
                replied = "response.output_audio.delta" in _types(events)
                attempts.append({"tone_hz": tone, "transcript": transcripts[0][1][:80], "replied": replied})
                if replied:
                    audio = events
                    break
            torch.cuda.synchronize()
            launches = {name: fn.launches for name, fn in counters.items()}
            seen = dict(encodes)
        finally:
            stop.set()
            manager.stop()
            GLOBAL_MODEL_CACHE.clear()
    finally:
        whisper.encode = real_encode
        smart_turn.SmartTurnAnalyzer.predict = real_predict
        for lg, level in zip(loggers, levels):
            lg.removeHandler(lines)
            lg.setLevel(level)

    text_pcm, text_done = _reply(text, "whisper serve text turn")
    check(audio is not None, f"whisper serve: a voice turn answered with audio: {attempts}")
    voice = _voice_summary(audio)
    messages = [r.getMessage() for r in lines.records]
    failed_logs = [m for m in messages if "Smart Turn inference failed" in m]
    finals = [r.args[0] for r in lines.records if r.getMessage().startswith("WhisperSTT final")]
    check(len(predictions) >= 1 and not failures and not failed_logs,
          f"Smart Turn ran: {len(predictions)} predictions, failures {failures}, failed logs {failed_logs}")
    check(launches["flash_attention"] > 0 and launches["log_mel"] > 0,
          f"the flash-attention and log-mel kernels launched in the whisper serve: {launches}")
    want_flash = WHISPER_LAYERS * seen["whisper"] + SMART_TURN_LAYERS * seen["smart_turn"]
    check(launches["flash_attention"] == want_flash and launches["log_mel"] == sum(seen.values()),
          f"launches {launches} against encodes {seen}: every encoder layer through the flash kernel "
          f"({want_flash}), every encode's log-mel through its kernel")
    phase("whisper_serve", card=card, flags=WHISPER_FLAGS[WHISPER_FLAGS.index("--stt"):], build_s=build_s,
          ttfa_s=_first_audio_s(text), text_turn_s=text_done, audio_seconds=text_pcm.size / 24_000,
          voice_attempts=attempts, voice_turn=voice, whisper_final_infer_s=finals,
          smart_turn_predictions=len(predictions),
          smart_turn_inference_ms=[p.inference_ms for p in predictions],
          smart_turn_probability=[p.probability for p in predictions], encodes=seen, launches=launches)
    return launches


def _first_audio_s(events) -> float:
    return next(t for t, e in events if e["type"] == "response.output_audio.delta")


def _reply(events, what: str) -> tuple[np.ndarray, float]:
    """A finished reply with non-silent audio: (PCM16 samples, seconds to
    ``response.done``)."""
    deltas = [e for _, e in events if e["type"] == "response.output_audio.delta"]
    done = [(t, e) for t, e in events if e["type"] == "response.done"]
    check(len(deltas) >= 1 and len(done) >= 1, f"{what}: {len(deltas)} audio deltas, {len(done)} response.done")
    status = done[-1][1]["response"]["status"]
    check(status == "completed", f"{what} status {status}")
    pcm = np.frombuffer(b"".join(base64.b64decode(e["delta"]) for e in deltas), np.int16)
    check(pcm.size > 0 and np.abs(pcm.astype(np.int32)).max() > 0, f"{what} audio is not silence")
    return pcm, done[-1][0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch", file=sys.stderr)
        return 1
    from s2s_tpu_torch.ops import _build  # outside a checkout of the repo this fails here

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    phase("card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    library, _ = _build.build()
    phase("build", library=str(library.name), seconds=_build.build_seconds)
    with no_tf32():
        int8 = weight_only_phase(dev, "int8")
        attn = attention_phase(dev)
        tiny_parity_phase(dev)
        tiny_batched_parity_phase(dev)
    single = serve_phase(dev)
    launches = batched_serve_phase(dev, smi)
    with no_tf32():
        dyn = int8_dyn_phase(dev, str(library))
        int4 = weight_only_phase(dev, "int4")
        micro = w8a8_microbench_phase(dev, dyn["rows"])
        tiny_quant_parity_phase(dev)
    quant_launches = quant_serve_phase(dev, smi)
    with no_tf32():
        flash = flash_attention_phase(dev)
        logmel = log_mel_phase(dev)
        tiny_whisper_parity_phase(dev)
    whisper_launches = whisper_serve_phase(dev, smi)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    mel_launches = {"whisper_serve": whisper_launches["log_mel"], "serve": single["parakeet_log_mel"],
                    "batched_serve": launches["parakeet_log_mel"]}
    print(smi[0])
    print(json.dumps({"kernels": [
        {"name": "int8_matmul", "route": "cuda", "source": "s2s_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "s2s_tpu/ops/int8_matmul.py:39", "launches": launches["int8_matmul"],
         **{k: int8[k] for k in keys}},
        {"name": "decode_attention", "route": "cuda", "source": "s2s_tpu_torch/csrc/decode_attention.cu",
         "replaces": "s2s_tpu/ops/decode_attention.py:44", "launches": launches["decode_attention"],
         **{k: attn[k] for k in keys}},
        {"name": "int8_matmul_dyn", "route": "cuda", "source": "s2s_tpu_torch/csrc/int8_matmul_dyn.cu",
         "replaces": "s2s_tpu/ops/int8_matmul.py:80", "launches": quant_launches["int8_matmul_dyn"],
         **{k: dyn[k] for k in keys}},
        {"name": "int4_matmul", "route": "cuda", "source": "s2s_tpu_torch/csrc/int4_matmul.cu",
         "replaces": "s2s_tpu/ops/int4_matmul.py:74", "launches": quant_launches["int4_matmul"],
         **{k: int4[k] for k in keys}},
        {"name": "flash_attention", "route": "cuda", "source": "s2s_tpu_torch/csrc/flash_attention.cu",
         "replaces": "s2s_tpu/ops/pallas_attention.py:68", "launches": whisper_launches["flash_attention"],
         **{k: flash[k] for k in keys}},
        # both callers: the Whisper cell's log-mels, the Parakeet cells' frontends
        {"name": "log_mel", "route": "cuda", "source": "s2s_tpu_torch/csrc/log_mel.cu",
         "replaces": "s2s_tpu/ops/pallas_mel.py:73", "launches": sum(mel_launches.values()),
         "launches_by_caller": mel_launches, **{k: logmel[k] for k in keys},
         "parakeet_frontend": {k: logmel["parakeet"][k] for k in ("rows", "seconds", "max_rel_err", "ms", "plain_ms",
                                                                  "row_loop_ms", "bound_ms", "bound_by",
                                                                  "library_ms")}},
        # the microbenchmark's kernel is #2's math: the W8A8 kernel, at its 16-row shape
        {"name": "w8a8_matmul", "route": "cuda", "source": "s2s_tpu_torch/csrc/int8_matmul_dyn.cu",
         "replaces": "scripts/microbench_w8a8.py:47", "launches": quant_launches["int8_matmul_dyn"],
         **{k: micro[k] for k in keys}},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
