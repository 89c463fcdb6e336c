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
   kernels with the most device time.

Phases 3 and 4 run with TF32 off, so that f32 products are compared in full
f32; the serves run with torch's defaults, as ``s2s_tpu_torch.cli`` does.

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
TEXT = "What is the weather like today?"
L2_BYTES = 50 << 20


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
            bound = 2 * bf16_ulp(want.float().abs().max().item())
            check(math.isfinite(err) and err <= bound, f"int8_matmul B={b} K={k} N={n}: |d|={err} > {bound}")
            max_err = max(max_err, err)

            def plain(i):
                mm.int8_matmul_reference(x, qs[i % copies], scale)

            def kernel(i):
                mm.int8_matmul(x, qs[i % copies], scale)

            calls = 2 * copies
            times = [device_ms(f, calls) for f in (plain, kernel, kernel, plain)]
            ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
            row = dict(B=b, K=k, N=n, max_abs_err=err, bound=bound, ms=ms, plain_ms=plain_ms,
                       kernel_GBps=k * n / (ms * 1e-3) / 1e9, splits=mm.split_count(b, k, n, _sms(dev)))
            phase("int8_matmul", **row)
            rows.append(row)
            if (b, k, n) == HEADLINE:
                headline = row
        del qs
    check(headline is not None, "headline shape measured")
    return {"max_abs_err": max_err, "ms": headline["ms"], "plain_ms": headline["plain_ms"], "rows": rows}


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
                bound = 2 * bf16_ulp(want.float().abs().max().item())
                check(got.shape == want.shape and math.isfinite(err) and err <= bound,
                      f"decode_attention {name} B={b} n={n}: |d|={err} > {bound}")
                max_err = max(max_err, err)

                def plain(i):
                    da.concat_attention_reference(q, *caches[i % copies], tk, tv, cl, tl)

                def kernel(i):
                    da.concat_attention(q, *caches[i % copies], tk, tv, cl, tl)

                times = [device_ms(f, 2 * copies) for f in (plain, kernel, kernel, plain)]
                ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
                valid = int(cache_len.sum()) + int(tl.sum().item())
                row = dict(shape=name, B=b, H=h, KV=kv, hd=hd, T=t, n=n, max_abs_err=err, bound=bound, ms=ms,
                           plain_ms=plain_ms, kernel_GBps=2 * valid * kv * hd * 2 / (ms * 1e-3) / 1e9)
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
                bound = 2 * bf16_ulp(want.float().abs().max().item())
                check(err <= bound, f"decode_attention (Pallas form) {name}: |d|={err} > {bound}")
                check(torch.equal(gk, wk) and torch.equal(gv, wv), f"decode_attention (Pallas form) {name} caches")
                phase("decode_attention_pallas_form", shape=name, B=b, max_abs_err=err, bound=bound,
                      caches_bitwise_equal=True)
            del caches
    check(headline is not None, "decode_attention headline shape measured")
    return {"max_abs_err": max_err, "ms": headline["ms"], "plain_ms": headline["plain_ms"]}


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

    print(json.dumps({"kernels": [
        {"name": "int8_matmul", "route": "cuda", "source": "s2s_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "s2s_tpu/ops/int8_matmul.py:39", "launches": launches["int8_matmul"],
         "max_abs_err": int8["max_abs_err"], "ms": int8["ms"], "plain_ms": int8["plain_ms"]},
        {"name": "decode_attention", "route": "cuda", "source": "s2s_tpu_torch/csrc/decode_attention.cu",
         "replaces": "s2s_tpu/ops/decode_attention.py:44", "launches": launches["decode_attention"],
         "max_abs_err": attn["max_abs_err"], "ms": attn["ms"], "plain_ms": attn["plain_ms"]},
    ]}))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
