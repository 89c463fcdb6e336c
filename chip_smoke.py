"""Smoke test of the PyTorch/CUDA port (``s2s_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, each printed on its own line:

1. the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
   no CUDA device -> exit 1 before anything else;
2. build every kernel from ``s2s_tpu_torch/csrc/`` with nvcc;
3. each kernel against its plain PyTorch version at the serving path's
   shapes, in bf16, bound 2 bf16 ulps of max|plain|; device times of both,
   taken in turns (plain, kernel, kernel, plain) with CUDA graphs over
   enough weight or cache copies to exceed the 50 MB L2: ``int8_matmul``,
   then ``decode_attention`` (tail form at the SmolLM2-1.7B and Qwen3-TTS
   talker shapes, and the Pallas-contract form, whose caches must come out
   bitwise equal to the plain version's);
4. tiny configs on the card against the same code on the CPU: the single-
   session models, then the batched LM and talker tail programs (the CPU
   path is held against the JAX package by ``tests/test_torch_port_*``);
5. the full-width single-session serve built by the port's builder with
   ``scripts/run_soak.py``'s ``--sessions 1`` flags, random weights from a
   seed, a warm-up text turn, then over a real WebSocket on 127.0.0.1 one
   text turn (audio deltas + response.done) and one audio turn (a
   transcription event, then, unless the random-init transcript is empty, a
   spoken reply with response.done); the int8 kernel's launch count over
   those two turns must be > 0;
6. the full-width 4-session batched serve with ``scripts/run_soak.py``'s
   ``--sessions 4`` flags (batched LM, TTS and Parakeet engines, warmed at
   build): four WebSocket clients send one text turn each at the same
   moment and must each get audio deltas and response.done, then one audio
   turn; both kernels' launch counts over those turns must be > 0;
7. one more concurrent 4-session round of that serve under
   ``torch.profiler`` (device activity only): the device's busy share
   between the round's first and last kernel, the kernels launched, and the
   kernels with the most device time;
8. the W8A8-dynamic and packed-int4 kernels against their plain versions
   (``int8_matmul_dyn`` bit-equal at the int8 shapes x 8-64 rows, with
   ``torch._int_mm`` plus its epilogue timed beside it above 16 rows;
   ``int4_matmul`` within 2 bf16 ulps at the code-predictor and LM shapes);
9. ``w8a8_microbench``, the port of ``scripts/microbench_w8a8.py``: the W8A8
   error against f32 at 16 rows x 2048 x 8192, then its seven-linear,
   24-layer, 8-step mix at 16 rows through the W8A8 kernel and through the
   W8A16 kernel, in GB/s of int8 weights;
10. the tiny f32 models on the card against the CPU under ``int8-dyn``,
   ``int4`` (LM) and ``int8-dyn``, ``int8+cp4``, ``int4`` (Qwen3-TTS);
11. the 4-session serve of phase 6 with ``--llm_quantize int8-dyn
   --tts_quantize int8+cp4``, after the first has shut down: one concurrent
   round of text turns, each answered with audio and response.done; the
   kernels' launches from the build (engine warm-up included) to the end of
   the round, with ``int8_matmul_dyn`` and ``int4_matmul`` each > 0.

Phases 3, 4, 8, 9 and 10 run with TF32 off, so that f32 products are
compared in full f32; the serves run with torch's defaults, as
``s2s_tpu_torch.cli`` does.  Every kernel's line and the JSON line give its
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the card's peak for their type.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before that line.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
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
#: decode attention at the serving shapes: (name, H, KV, hd, T, tails); T is
#: the engine's --*_batched_max_t, the tails the steady chunk first, then the
#: priority / ramp chunk sizes
ATTN_SHAPES = [("smollm2-1.7b", 32, 32, 64, 512, (6, 1, 2, 4, 8, 12)),
               ("qwen3-tts-talker", 16, 8, 128, 192, (3, 2, 4))]
ATTN_ROWS = [1, 4, 16]
#: the decode-attention shape in the JSON line: the 4-session LM steady chunk
ATTN_HEADLINE = ("smollm2-1.7b", 4, 6)
#: (K, N) of the int8 linears: SmolLM2-1.7B, then the Qwen3-TTS talker and
#: code predictor
INT8_SHAPES = [(2048, 2048), (2048, 8192), (8192, 2048), (2048, 1024), (2048, 6144), (6144, 2048)]
INT8_ROWS = [1, 2, 17, 64]
#: the shape whose times stand in the JSON line: a talker/code-predictor
#: gate or up projection at decode (1 row)
HEADLINE = (1, 2048, 6144)
#: the W8A8 rows: the 16-, 32- and 64-token prompt buckets and 8- and
#: 16-slot steady steps (fewer rows take the W8A16 route)
DYN_ROWS = [8, 16, 32, 64]
#: the W8A8 shape in the JSON line: a SmolLM2-1.7B gate/up projection in the
#: 32-token prompt bucket (above 16 rows, so ``torch._int_mm`` runs beside it)
DYN_HEADLINE = (32, 2048, 8192)
#: (K, N) of the int4 linears: the Qwen3-TTS code predictor, then the
#: SmolLM2-1.7B shapes it does not share
INT4_SHAPES = [(2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048), (2048, 8192), (8192, 2048)]
INT4_ROWS = [1, 2, 4, 16, 64]
#: the int4 shape in the JSON line: a code-predictor gate/up projection at
#: the 4-session steady step
INT4_HEADLINE = (4, 2048, 6144)
QUANT_FLAGS = ["--llm_quantize", "int8-dyn", "--tts_quantize", "int8+cp4"]
TEXT = "What is the weather like today?"
L2_BYTES = 50 << 20
#: H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, dense bf16 FLOP/s, dense int8 OP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12


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


def kernel_phase(dev: torch.device) -> dict:
    from s2s_tpu_torch.ops import int8_matmul as mm

    gen = torch.Generator(device=dev).manual_seed(0)
    rows, max_err, headline = [], 0.0, None
    for k, n in INT8_SHAPES:
        copies = max(2, -(-2 * L2_BYTES // (k * n)))
        qs = [torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int16).to(torch.int8)
              for _ in range(copies)]
        scale = torch.rand(n, generator=gen, device=dev) * 0.01 + 1e-4
        for b in INT8_ROWS:
            x = torch.randn(b, k, generator=gen, device=dev).to(torch.bfloat16)
            got = mm.int8_matmul(x, qs[0], scale)
            want = mm.int8_matmul_reference(x, qs[0], scale)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == torch.bfloat16, f"int8_matmul output {got.shape}")
            err = (got.float() - want.float()).abs().max().item()
            tol = 2 * bf16_ulp(want.float().abs().max().item())
            check(math.isfinite(err) and err <= tol, f"int8_matmul B={b} K={k} N={n}: |d|={err} > {tol}")
            max_err = max(max_err, err)

            def plain(i):
                mm.int8_matmul_reference(x, qs[i % copies], scale)

            def kernel(i):
                mm.int8_matmul(x, qs[i % copies], scale)

            calls = 2 * copies
            times = [device_ms(f, calls) for f in (plain, kernel, kernel, plain)]
            ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
            bound_ms, bound_by = gemv_bound(b, k, n, k * n, BF16_FLOPS)
            row = dict(B=b, K=k, N=n, max_abs_err=err, bound=tol, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       kernel_GBps=k * n / (ms * 1e-3) / 1e9, splits=mm.split_count(b, k, n, _sms(dev)))
            phase("int8_matmul", **row)
            rows.append(row)
            if (b, k, n) == HEADLINE:
                headline = row
        del qs
    check(headline is not None, "headline shape measured")
    return {"max_abs_err": max_err, "ms": headline["ms"], "plain_ms": headline["plain_ms"],
            "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"], "library_ms": None, "rows": rows}


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def attention_phase(dev: torch.device) -> dict:
    """decode_attention against its plain version at the serving shapes:
    lengths from a seed, row 0 at the full cache; then the Pallas-contract
    form at B=4, whose caches must match the plain version's bit for bit."""
    from s2s_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
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
                           kernel_GBps=2 * valid * kv * hd * 2 / (ms * 1e-3) / 1e9)
                if (name, b, n) == ATTN_HEADLINE:
                    row["library_ms"] = _sdpa_ms(q, caches, tk, tv, cl, tl)
                phase("decode_attention", **row)
                rows.append(row)
                if (name, b, n) == ATTN_HEADLINE:
                    headline = row
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


def int8_dyn_phase(dev: torch.device) -> dict:
    """``int8_matmul_dyn`` against its plain version at the int8 shapes and
    8-64 rows: bit-equal (error 0), with device times of the kernel, the
    plain version and, above 16 rows, ``torch._int_mm`` plus its epilogue."""
    from s2s_tpu_torch.ops import int8_matmul as mm

    gen = torch.Generator(device=dev).manual_seed(6)
    rows, headline = [], None
    for k, n in INT8_SHAPES:
        copies = max(2, -(-2 * L2_BYTES // (k * n)))
        qs = [torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int16).to(torch.int8)
              for _ in range(copies)]
        scale = torch.rand(n, generator=gen, device=dev) * 0.01 + 1e-4
        for b in DYN_ROWS:
            x = (3 * torch.randn(b, k, generator=gen, device=dev)).to(torch.bfloat16)
            got = mm.int8_matmul_dyn(x, qs[0], scale)
            want = mm.int8_matmul_dyn_reference(x, qs[0], scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(got.shape == want.shape and torch.equal(got, want),
                  f"int8_matmul_dyn B={b} K={k} N={n}: not bit-equal to the plain version (|d|={err})")

            def plain(i):
                mm.int8_matmul_dyn_reference(x, qs[i % copies], scale)

            def kernel(i):
                mm.int8_matmul_dyn(x, qs[i % copies], scale)

            times = [device_ms(f, 2 * copies) for f in (plain, kernel, kernel, plain)]
            ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
            bound_ms, bound_by = gemv_bound(b, k, n, k * n, INT8_OPS)
            row = dict(B=b, K=k, N=n, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=_int_mm_ms(x, qs, scale) if b > 16 else None,
                       kernel_GBps=k * n / (ms * 1e-3) / 1e9, splits=mm.split_count(b, k, n, _sms(dev)))
            phase("int8_matmul_dyn", **row)
            rows.append(row)
            if (b, k, n) == DYN_HEADLINE:
                headline = row
        del qs
    check(headline is not None, "int8_matmul_dyn headline shape measured")
    return {"max_abs_err": 0.0, **{key: headline[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                                   "library_ms")}}


def int4_phase(dev: torch.device) -> dict:
    """``int4_matmul`` against its plain version at the code-predictor and
    LM shapes x 1-64 rows, within 2 bf16 ulps of max|plain|, packed weights
    cycled past the L2; no single PyTorch call computes packed int4."""
    from s2s_tpu_torch.ops import int4_matmul as m4
    from s2s_tpu_torch.ops.int8_matmul import split_count

    gen = torch.Generator(device=dev).manual_seed(7)
    rows, max_err, headline = [], 0.0, None
    for k, n in INT4_SHAPES:
        copies = max(2, -(-2 * L2_BYTES // (k * n // 2)))
        qs = [torch.randint(-128, 128, (k // 2, n), generator=gen, device=dev, dtype=torch.int16).to(torch.int8)
              for _ in range(copies)]
        scale = torch.rand(n, generator=gen, device=dev) * 0.01 + 1e-4
        for b in INT4_ROWS:
            x = torch.randn(b, k, generator=gen, device=dev).to(torch.bfloat16)
            got = m4.int4_matmul(x, qs[0], scale)
            want = m4.int4_matmul_reference(x, qs[0], scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = 2 * bf16_ulp(want.float().abs().max().item())
            check(got.shape == want.shape and math.isfinite(err) and err <= tol,
                  f"int4_matmul B={b} K={k} N={n}: |d|={err} > {tol}")
            max_err = max(max_err, err)

            def plain(i):
                m4.int4_matmul_reference(x, qs[i % copies], scale)

            def kernel(i):
                m4.int4_matmul(x, qs[i % copies], scale)

            times = [device_ms(f, 2 * copies) for f in (plain, kernel, kernel, plain)]
            ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
            bound_ms, bound_by = gemv_bound(b, k, n, k * n // 2, BF16_FLOPS)
            row = dict(B=b, K=k, N=n, max_abs_err=err, bound=tol, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, kernel_GBps=k * n / 2 / (ms * 1e-3) / 1e9,
                       splits=split_count(b, k // 2, n, _sms(dev)))
            phase("int4_matmul", **row)
            rows.append(row)
            if (b, k, n) == INT4_HEADLINE:
                headline = row
        del qs
    check(headline is not None, "int4_matmul headline shape measured")
    return {"max_abs_err": max_err, "library_ms": None,
            **{key: headline[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}}


def w8a8_microbench_phase(dev: torch.device) -> None:
    """The port of ``scripts/microbench_w8a8.py``: the W8A8 error against an
    f32 product at 16 rows x 2048 x 8192, then its mix (per step and layer,
    seven linears of SmolLM2-1.7B's widths, 24 layers, 8 steps, 16 rows, the
    8192-wide input tiled from the 2048-wide one) captured as one CUDA graph,
    through the W8A8 kernel and through the W8A16 kernel, in turns; GB/s of
    int8 weights read."""
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

    return {"int8_matmul": mm.int8_matmul, "decode_attention": da.concat_attention,
            "int8_matmul_dyn": mm.int8_matmul_dyn, "int4_matmul": m4.int4_matmul}


def quant_serve_phase(dev: torch.device, card: list[str]) -> dict[str, int]:
    """The 4-session batched serve with ``--llm_quantize int8-dyn
    --tts_quantize int8+cp4``: build (engines warmed), then one concurrent
    round of text turns.  Every count is set to 0 just before the build and
    read after the warm-up and after the round; returns the counts over the
    whole serve.  At 4 slots the LM's W8A8 calls of 8-64 rows are the 16-,
    32- and 64-token prompt buckets, which the warm-up runs (the round's
    prompts fill the 512 bucket, its steady steps have 4 rows)."""
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
        manager, server, _ = cli.build_from_argv(["--device", "cuda", *BATCHED_FLAGS, *QUANT_FLAGS], stop)
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
        t0 = time.perf_counter()
        rounds = asyncio.run(_concurrent_text_turns(url, SESSIONS))
        round_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
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
    check(in_round["int4_matmul"] > 0, f"the int4 kernel launched in the quantized round: {in_round}")
    phase("quant_serve", card=card, sessions=SESSIONS, flags=QUANT_FLAGS, build_s=build_s, warmup_s=warm["s"],
          round_s=round_s, text_turns=sessions, launches=launches, launches_warmup=warm["launches"],
          launches_round=in_round)
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


def _audio_turn():
    rate = 16_000
    t = np.arange(2 * rate) / rate
    speech = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
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


def serve_phase(dev: torch.device) -> int:
    """The single-session serve: a warm-up text turn, then a measured text
    turn and a voice turn; returns the int8 kernel's launches over those."""
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.ops import int8_matmul as mm
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

        mm.int8_matmul.launches = 0  # count the measured turns only
        text = asyncio.run(_session(url, _text_turn(TEXT), _response_done, 600))
        audio = asyncio.run(_session(url, _audio_turn(), _transcribed_and_settled, 600))
        torch.cuda.synchronize()
        launches = mm.int8_matmul.launches
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()

    text_pcm, text_done = _reply(text, "text turn")
    voice = _voice_summary(audio)
    check(launches > 0, "int8 kernel launched during the turns")
    phase("serve", build_s=build_s, warmup_turn_s=warmup_s, ttfa_s=_first_audio_s(text), text_turn_s=text_done,
          audio_seconds=text_pcm.size / 24_000, voice_turn=voice, int8_launches=launches)
    return launches


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
    from s2s_tpu_torch.ops import int8_matmul as mm
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
        mm.int8_matmul.launches = da.concat_attention.launches = 0  # count the measured turns only
        t0 = time.perf_counter()
        rounds = asyncio.run(_concurrent_text_turns(url, SESSIONS))
        round_s = time.perf_counter() - t0
        audio = asyncio.run(_session(url, _audio_turn(), _transcribed_and_settled, 600))
        torch.cuda.synchronize()
        launches = {"int8_matmul": mm.int8_matmul.launches, "decode_attention": da.concat_attention.launches}
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
    phase("batched_serve", card=card, sessions=SESSIONS, build_s=build_s, warmup_s=warm["s"], round_s=round_s,
          text_turns=sessions, voice_turn=voice, launches=launches)
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
            if any(k in name for k in ("decode_attention_kernel", "int8_gemv_kernel", "splitk_reduce_kernel"))}
    return {"sessions": SESSIONS, "done_s": [d for _, d in replies],
            "audio_seconds": [pcm.size / 24_000 for pcm, _ in replies], "span_s": span_s,
            "device_busy_s": busy_ns / 1e9, "device_busy_share": busy_ns / 1e9 / span_s,
            "device_ops": len(device),
            "top": [{"name": name, "device_ms": ns / 1e6, "calls": n} for name, (ns, n) in top],
            "port_kernels": ours}


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
    path, _ = _build.build()
    phase("build", library=str(path.name), seconds=_build.build_seconds)
    with no_tf32():
        int8 = kernel_phase(dev)
        attn = attention_phase(dev)
        tiny_parity_phase(dev)
        tiny_batched_parity_phase(dev)
    serve_phase(dev)
    launches = batched_serve_phase(dev, smi)
    with no_tf32():
        dyn = int8_dyn_phase(dev)
        int4 = int4_phase(dev)
        w8a8_microbench_phase(dev)
        tiny_quant_parity_phase(dev)
    quant_launches = quant_serve_phase(dev, smi)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
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
    ]}))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
