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
   regime's time at up to 8 rows; also at one rank's shapes of two,
   ``tp_serve``'s), then ``decode_attention`` (tail form at the SmolLM2-1.7B and Qwen3-TTS
   talker shapes, the talker at its max_seq_len 4096, whose keys stream
   through a ring of tiles, and one rank's heads of two, with ``F.scaled_dot_product_attention`` timed
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
   bucket, 50-1500 positions), at Smart Turn's (6 heads x 400), one
   causal shape and SigLIP's (12 heads x 1,024 patches), within 2 bf16
   ulps of max|plain|, with device times of
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
   earlier serves shut down, from checkpoints the conversion tool wrote
   (``write_serve_checkpoints``: SmolLM2-1.7B as BF16 safetensors,
   distil-large-v3 as F16 safetensors, Smart Turn as an F32 ``.pt``, drawn
   at the published shapes from torch seeds, each converted by ``python -m
   s2s_tpu_torch.tools.convert_checkpoint`` in a subprocess), so the
   single-session LM is int8: one text turn, then voice turns (``VOICE_TONES_HZ``,
   up to the first one answered), each with a non-empty transcription; the
   answered one must bring reply audio and ``response.done``; Smart Turn
   predictions with none failed, launches of both encoder kernels that
   match the encodes (one flash launch per encoder layer, one log-mel per
   encode) and int8 launches > 0; then the served weights against their
   sources (``check_served_weights``) and a ``checkpoint`` line (each
   file's bytes, each conversion's seconds and peak RSS, each load's
   seconds at build);
16. ``silero`` (run after phase 4): ``BatchedSileroVAD(max_slots=16)`` on
   the card against the plain masked step on the CPU with the same
   parameters over 64 ticks of noise, tones and silence, the active slots
   moving over 1, 4 and 16, within ``SILERO_ATOL`` on every probability and
   the final carry; a tick of one slot leaves the other rows' carry bitwise
   unchanged, ``reset_slot`` zeroes its row only; the single-session
   ``SileroVAD`` on the card against the CPU; a tick's device time (CUDA
   graph), wall time with the host round trip and its kernels and copies
   (``torch.profiler``) at 1 and 16 active slots;
17. ``talk`` (inside phase 5, against its running server): the headless
   client of ``s2s-tpu-torch talk`` streams the voice turn's WAV at real
   time and must write non-silent reply PCM;
18. ``head_logits``: a distil-large-v3 decode step after the first must
   allocate less than half its f32 embedding (the heads keep their f32
   weight once, ``models/common.py::f32_weight``); the Whisper, codec and
   code-predictor heads timed with the kept weight, the per-call cast it
   replaced and ``torch.mm(..., out_dtype=torch.float32)``;
19. ``resample``: ``torch_resample_poly`` on the card against scipy and
   against the same function on the CPU at ``RESAMPLE_RATES``, within
   ``RESAMPLE_ATOL``;
20. ``deployment_serve``: ``examples/smollm2-qwen3tts-tpu/config.json``
   through its JSON form (``deployment_config``: no checkpoint or tokenizer
   keys, the server on 127.0.0.1 port 0) after the earlier serves shut
   down: two text turns (``DEPLOYMENT_REPLY``: at most 64 tokens a reply)
   answered with audio and response.done, then 3 s of
   audio streamed in: Silero must tick once per 512 samples with every
   probability in [0, 1], no error event may come; the int8 and
   decode-attention kernels must launch in the phase.
21. ``tiny_kokoro_parity`` and ``tiny_vits_parity`` (after phase 4): tiny
   Kokoro-82M on the card against the same weights and inputs on the CPU
   (durations equal, phase A within ``KOKORO_PHASE_A_ATOL``, two syntheses
   within ``KOKORO_WAV_ATOL`` and a relative RMS under
   ``KOKORO_WAV_REL_RMS``), tiny MMS/VITS likewise, its zero-initialized
   flow projections drawn (``vits_flow_weights``; two lengths in one
   bucket, deterministic and with noise: ``n_samples`` equal, the waveform
   within ``VITS_WAV_ATOL``, exact zeros past each length);
22. ``kokoro_serve`` and ``mms_serve`` (after phase 16): the 4-session
   batched cascade of phase 6 with ``--tts kokoro`` or ``--tts
   facebookMMS`` (``tts_flags``: the ``--tts_*`` flags it lacks dropped), full width,
   random weights: four concurrent text turns and voice turns up to the
   first one answered, every reply non-silent with ``response.done``, the
   int8, decode-attention and Parakeet log-mel kernels launched in the
   turns (the log-mel once a transcription batch); the TTFA of each
   session, the served syntheses' RTF (audio seconds over wall seconds),
   and one synthesis at Kokoro's token buckets 64 and 256
   (``SYNTH_TEXTS``): wall time, peak allocation, and each part's device
   time and kernels (Kokoro's phase A, alignment and phase B; VITS's one
   program), and its share of non-finite samples and largest finite one
   (with random weights Kokoro's exp head overflows: the serve's gate shows
   only that the serve completes);
23. ``tiny_pocket_parity`` and ``tiny_chattts_parity`` (after phase 21):
   tiny Pocket-TTS and ChatTTS on the card against the CPU with their
   torch twins' weights (``POCKET_FIXTURE``, ``CHATTTS_FIXTURE``: the
   fixtures through the JAX converters, stored as converted checkpoints):
   greedy codes equal to the fixtures' (Pocket with and without its voice
   prefix, ChatTTS with and without its speaker), Mimi's waveform within
   ``MIMI_WAV_ATOL``, ChatTTS's mel within ``CHATTTS_MEL_ATOL``; random
   weights: Pocket's codes equal and its stream, ChatTTS's syntheses
   within ``TTS_WAV_REL`` x max|CPU|; each card run repeated with TF32 on
   as a reading, not a gate;
24. ``pocket_serve`` and ``chattts_serve`` (after phase 22): phase 22's
   cascade with ``--tts pocket`` (``PocketTTSConfig()`` with ``MimiConfig()``,
   bf16 LM, f32 Mimi; its output conv scaled by ``POCKET_MIMI_OUT_SCALE``
   so random audio clears the silence trim) or ``--tts chatTTS``
   (``ChatTTSConfig()``, f32), each LM at ``POCKET_SERVE_LAYERS`` or
   ``CHATTTS_SERVE_LAYERS`` (half its depth; ``served_tts_model``), with the same gate; each served synthesis
   timed inside the model's ``stream``; profiles of ``SYNTH_TEXTS`` (and,
   for Pocket, ``TEXT`` through a random voice prefix of
   ``POCKET_VOICE_ROWS`` rows; ``PROFILED_TEXTS`` for both, ``TEXT`` alone
   since the long text was cut): Pocket's 8-frame chunks split into frame
   generation and the Mimi re-decode, ChatTTS's synthesis into the prefill
   with the AR loop and the DVAE with Vocos and the iSTFT;
25. ``tiny_paraformer_parity``, ``tiny_vlm_parity`` and
   ``tiny_deepfilter_parity`` (after phase 23): the converted fixtures
   (``PARAFORMER_FIXTURE``, ``SMOLVLM_FIXTURE``, ``DEEPFILTER_FIXTURE``)
   and weights from torch seeds on the card against the CPU: Paraformer's
   token ids and counts equal (the fixture's on both), its encoder within
   ``PARAFORMER_ENC_ATOL``, LFR + CMVN bit-equal; the tiny SigLIP tower and
   the merged SmolVLM forward through ``prefill_embeds`` within
   ``VISION_ATOL`` (its argmax the fixture's), the tiny VLM stage's greedy
   text on a PNG equal; DeepFilter's frames and a 3 s ``DeepFilterConfig()``
   enhancement within ``DEEPFILTER_REL`` x max|CPU|;
26. ``paraformer_vlm_serve`` (after every other serve): the single-session
   serve with ``--stt paraformer`` (Paraformer-large), ``--llm_backend
   local-vlm`` (SmolLM2-1.7B behind ``VisionConfig()``), ``--tts
   facebookMMS`` and ``--vad_enhancer_checkpoint`` (a ``DeepFilterConfig()``
   tree from seed 0): a voice turn (a transcription; one log-mel launch per
   Paraformer forward, one DeepFilter call per VAD final, finite and of the
   same length), an image turn (one tower run and ``SIGLIP_LAYERS`` flash
   launches per attempt, answered with audio; a failed image decode fails
   the phase), a text turn with no tower run; then a Paraformer
   forward's, the tower's and DeepFilter's device and wall times;
27. ``convert_parity`` (after phase 25): every converter of the port
   (``convert_cases``: each family's fixture at its tiny config, and bf16
   configs of the decoder LM, Whisper, Qwen3-TTS and Parakeet) on the card,
   every leaf landing there, its arrays by ``array_digests`` equal to
   ``CONVERTED_DIGESTS`` (the JAX converters' on the CPU); F32, F16 and
   BF16 safetensors files through the tool's writer and reader, bit for
   bit;
28. ``tiny_train_parity`` (after phase 26): the tiny f32 decoder's training
   path on the card against the CPU, three AdamW steps through
   ``make_sharded_train_step`` on a 1 x 1 mesh of each and three
   ``sgd_train_step``s, losses and parameters within ``TINY_TRAIN_REL``;
29. ``train``: full-width SmolLM2-1.7B, random weights from a seed, takes
   ``TRAIN_STEPS`` AdamW steps on a 1 x 1 mesh of the card
   (``make_mesh()``) over a ``TRAIN_BATCH`` batch from a numpy seed: each
   step's loss (finite, the last below the first), wall and device time,
   the last step's kernels and busy time under ``torch.profiler``, the
   peak allocation; no hand-written kernel may launch (the path reaches
   none); then ``forward`` over a ``SCORE_PROMPT``-token prompt at its last
   position against ``prefill``'s logits, within ``SCORE_ULPS`` bf16 ulps.

30. ``tp_parity`` (after phase 4): tensor parallelism over ``TP_RANKS``
   ranks, rank 0 here and the others in processes of their own, both on
   this card through gloo (``TP_REHEARSAL``): the tiny f32 LM's slot prefill
   and tail chunk and the tiny talker's fused prefill and gathered chunk
   (head dim 64, the decode-attention kernel's) over the ranks against one
   rank: tokens and codes equal, audio within ``TP_TALKER_ATOL``;
   SmolLM2-1.7B's int8 prefill logits within ``TP_LOGITS_REL``; the
   transport's all_reduce time; with two or more cards the same over NCCL;
31. ``tp_serve`` (after phase 6): on one card ``serve --model_parallel 2``
   must raise the device-count error; then the 4-session serve with
   ``--tts_quantize int8 --model_parallel 2`` (``TP_SERVE_FLAGS``), full
   width and depth, the follower started by the serve on the same card
   (a rehearsal, not TP's speed on two cards): four concurrent text turns
   answered with audio and response.done, an audio turn, the int8 and
   decode-attention launches of each rank (> 0, equal), each rank's
   allocated bytes, each engine's replicated state equal on every rank.

Since ``tp_serve`` joined, the serves other than phase 31 run
SmolLM2-1.7B (except phases 6 and 15), the Qwen3-TTS talker and its code
predictor cut in depth (``SERVE_DEPTHS``, widths kept).  After every serve a ``serve_memory`` line
gives what stays allocated on the card once the phase has returned, before
and after a garbage collection.

Phases 3, 4, 8, 9, 10, 12, 13, 14, 21, 23, 25, 27 and 28 run with TF32 off, so that f32
products are compared in full f32; the serves and phases 16-20 run with
torch's defaults, as ``s2s_tpu_torch.cli`` does (cuDNN's convolutions, so
Kokoro's and VITS's, in TF32).  A ``seconds`` line gives each
phase's time.  Every kernel's line and the JSON line give its
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the card's peak for their type.

After the phases come the card's ``nvidia-smi`` name and power limit, then,
on the line before the last, a JSON object of the kernels (``launches`` from
their main paths' serves; the int8 and decode-attention entries also carry
the deployment, Kokoro, MMS, Pocket and ChatTTS serves' as
``deployment_serve_launches``, ``kokoro_serve_launches``,
``mms_serve_launches``, ``pocket_serve_launches`` and
``chattts_serve_launches``, and the int8 entry the Whisper serve's as
``whisper_serve_launches`` (those on the LM's weights as
``whisper_serve_lm_launches``); the log-mel's ``launches_by_caller`` counts
those four TTS serves and the Paraformer serve too, the flash kernel's the
Whisper and the Paraformer/VLM serves, and its ``siglip`` entry SigLIP's
shape; the int8 and decode-attention entries carry ``tp_serve``'s launches,
leader first, as ``tp_serve_launches_by_rank``); the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before those lines.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import dataclasses
import gc
import json
import logging
import math
import os
import struct
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import torch
from torch.utils import _pytree as pytree

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
                + [("smart-turn", 6, 400, False), ("causal", 20, 1500, True), ("siglip", 12, 1024, False)])
#: the flash shape in the JSON line: Smart Turn, run at every soft end of speech;
#: SigLIP's (12 heads of 64 over 1,024 patches) beside it
FLASH_HEADLINE = ("smart-turn", 6, 400, False)
FLASH_SIGLIP = ("siglip", 12, 1024, False)
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
#: priority / ramp chunk sizes; then the talker at its max_seq_len, whose
#: keys do not fit a CTA at once and stream through a ring of tiles; last
#: one rank's heads of two (tp_serve)
ATTN_SHAPES = [("smollm2-1.7b", 32, 32, 64, 512, (6, 1, 2, 4, 8, 12)),
               ("qwen3-tts-talker", 16, 8, 128, 192, (3, 2, 4)),
               ("qwen3-tts-talker-4096", 16, 8, 128, 4096, (3,)),
               ("smollm2-1.7b-rank-of-2", 16, 16, 64, 512, (6, 1, 2, 4, 8, 12)),
               ("qwen3-tts-talker-rank-of-2", 8, 4, 128, 192, (3, 2, 4))]
ATTN_ROWS = [1, 4, 16]
#: the decode-attention shape in the JSON line: the 4-session LM steady chunk
ATTN_HEADLINE = ("smollm2-1.7b", 4, 6)
#: (K, N) of the int8 linears: SmolLM2-1.7B, then the Qwen3-TTS talker and
#: code predictor
INT8_SHAPES = [(2048, 2048), (2048, 8192), (8192, 2048), (2048, 1024), (2048, 6144), (6144, 2048)]
#: (K, N) of one rank's int8 linears of two (tp_serve), where they differ
#: from the above: SmolLM2-1.7B's wo, gate/up and down, then the talker's
#: wk/wv, gate/up and down (wq's 2048 -> 1024 is above); int8_matmul only
TP_INT8_SHAPES = [(1024, 2048), (2048, 4096), (4096, 2048), (2048, 512), (2048, 3072), (3072, 2048)]
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
#: Silero: the batched service's slots and ticks (noise, tones and silence;
#: the active slots move over 1, 4 and 16 of them, 16 ticks, 16, then 32)
SILERO_SLOTS = 16
SILERO_TICKS = 64
#: Silero's pass mark on the probabilities and the carry: the JAX package's
#: own batched-vs-single bound (``tests/test_batcher.py``), both sides f32
SILERO_ATOL = 1e-5
#: the device resampler's rate pairs, and its pass mark against scipy and
#: against the same function on the CPU: the JAX package's bound of
#: ``jax_resample_poly`` against scipy (``tests/test_audio_frontend.py``)
RESAMPLE_RATES = [(24_000, 16_000), (16_000, 24_000), (48_000, 16_000)]
RESAMPLE_ATOL = 2e-5
#: the repo's deployment config (Silero VAD, Smart Turn, int8 LLM and TTS,
#: speculation, 16 TTS slots); its checkpoints and tokenizers are not in the
#: repository, so those keys are left out and the models random-init
DEPLOYMENT_CONFIG = "examples/smollm2-qwen3tts-tpu/config.json"
#: the audio streamed into the deployment serve after its text turns
DEPLOYMENT_AUDIO_S = (1.5, 1.5)  # tone, then silence
#: what the deployment serve's text turns ask of ``response.create``: replies
#: of at most 64 tokens, the other serves' ``--llm_max_new_tokens`` (the
#: config's own cap, 256, made random-init turns of 25 s of audio and 80-160
#: s each on an H100, a quarter of the whole run)
DEPLOYMENT_REPLY = {"max_output_tokens": 64}
#: one synthesis measured at each of Kokoro's token buckets 64 and 256 (byte
#: ids: no vocab without a converted checkpoint), the same texts for MMS
SYNTH_TEXTS = {64: TEXT, 256: " ".join([TEXT] * 6)}
#: tiny Kokoro on the card against the CPU (TF32 off): phase A as the CPU
#: tests hold it against the JAX package; the waveform by the JAX package's
#: bounds against its torch twin (the exp/sin head amplifies sum-order noise)
KOKORO_PHASE_A_ATOL = 1e-5
KOKORO_WAV_ATOL, KOKORO_WAV_REL_RMS = 2e-3, 1e-3
#: tiny VITS on the card against the CPU: the JAX package's bound against
#: transformers' VitsModel
VITS_WAV_ATOL = 2e-4
#: tiny Pocket-TTS and ChatTTS from their torch twins' fixtures through the
#: JAX converters, stored as converted checkpoints beside the fixtures'
#: inputs and outputs (``tests/test_torch_port_{pocket,chattts}.py`` hold
#: each file equal to the converters' output; this script imports nothing of
#: the JAX package)
POCKET_FIXTURE = "tests/data/pocket_parity_converted.npz"
CHATTTS_FIXTURE = "tests/data/chattts_parity_converted.npz"
#: the Mimi waveform on the card against the CPU (TF32 off): the JAX
#: package's bound against its torch twin
MIMI_WAV_ATOL = 2e-6
#: ChatTTS's mel on the card against the CPU: the JAX package's DVAE bound;
#: a whole waveform (Pocket's stream, ChatTTS through its exp head and the
#: iSTFT) relative to max|CPU|: the CPU tests' bound against the JAX package
CHATTTS_MEL_ATOL = 1e-5
TTS_WAV_REL = 1e-5
#: random Mimi at full width peaks near 1.5e-3, under the TTS handler's
#: 0.01 silence threshold, so every reply would be trimmed to nothing: the
#: served Pocket model's output conv is scaled by this (tests/test_tts.py
#: scales the tiny one's by 2000 for the same reason); random ChatTTS peaks
#: near 0.08 and is served as drawn
POCKET_MIMI_OUT_SCALE = 50.0
#: the profiled voiced Pocket synthesis: a random voice prefix of this many
#: rows of backbone width, added with ``PocketTTS.add_voice``
POCKET_VOICE_ROWS = 32
#: a profiled synthesis traces this many 8-frame chunks' frame generation
#: (Pocket) or AR steps (ChatTTS) and runs the rest untraced: every one of
#: ``TEXT``'s, the first of the long text's (each chunk and step is the same
#: work but for its cache length; tracing a kernel costs about 3x its host
#: time, and the long texts' full traces took 70 s of the run); Mimi's
#: re-decodes and ChatTTS's prefill, DVAE and Vocos are traced in full
POCKET_TRACED_CHUNKS = 8
CHATTTS_TRACED_STEPS = 180
#: the texts of Pocket's and ChatTTS's profiled syntheses: ``TEXT`` alone
#: (the long text's two syntheses a family took about 90 s of the run; PERF.md
#: keeps their numbers)
PROFILED_TEXTS = (TEXT,)
#: the Pocket-TTS and ChatTTS serves' LM depths: (backbone, depformer)
#: layers of 16 and 6, and ChatTTS's GPT of 20, halved (their widths kept)
#: so the whole run keeps its time since the Whisper cell converts its
#: checkpoints (PERF.md, the converters' finding)
POCKET_SERVE_LAYERS = (8, 3)
CHATTTS_SERVE_LAYERS = 10
#: the served TTS families: the phase name and the model's method each
#: served synthesis goes through (timed; Pocket and ChatTTS stream)
TTS_SERVES = {"kokoro": ("kokoro_serve", "synthesize"), "facebookMMS": ("mms_serve", "synthesize"),
              "pocket": ("pocket_serve", "stream"), "chatTTS": ("chattts_serve", "stream")}
#: the depths of SmolLM2-1.7B (24 layers), of the Qwen3-TTS talker (28) and
#: of its code predictor (5, run 15 times a frame) in the serves other than
#: the tensor-parallel one, cut (their widths kept) so the whole run keeps
#: its time since ``tp_serve`` joined it (PERF.md §4): serve name -> (LM,
#: talker, code-predictor layers), None where the serve keeps the model
#: whole (the main path's, ``batched_serve``, keeps its int8 LM whole; the
#: Whisper serve's LM comes from a converted checkpoint of its published
#: depth)
SERVE_LM_LAYERS, SERVE_TALKER_LAYERS, SERVE_CP_LAYERS = 12, 14, 2
SERVE_TTS = (SERVE_TALKER_LAYERS, SERVE_CP_LAYERS)
SERVE_DEPTHS = {"serve": (SERVE_LM_LAYERS, *SERVE_TTS),
                "batched_serve": (None, *SERVE_TTS),
                **{TTS_SERVES[t][0]: (SERVE_LM_LAYERS, None, None) for t in TTS_SERVES},
                "quant_serve": (SERVE_LM_LAYERS, *SERVE_TTS),
                "whisper_serve": (None, *SERVE_TTS),
                "deployment_serve": (SERVE_LM_LAYERS, *SERVE_TTS)}
#: tiny Paraformer, SigLIP with the fixture's text model, and DeepFilter,
#: each from its torch twin's (or transformers') fixture through the JAX
#: converters, stored as converted checkpoints (``tests/test_torch_port_
#: {paraformer,vision,deepfilter}.py`` hold each file equal to the
#: converters' output)
PARAFORMER_FIXTURE = "tests/data/paraformer_parity_converted.npz"
SMOLVLM_FIXTURE = "tests/data/smolvlm_parity_converted.npz"
DEEPFILTER_FIXTURE = "tests/data/deepfilter_parity_converted.npz"
#: the SmolVLM fixture's text model (``tests/test_torch_parity.py``'s)
SMOLVLM_LM = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                  max_seq_len=128, rope_theta=10000.0, rms_eps=1e-5, tie_embeddings=True)
#: card against CPU, TF32 off, f32 on both sides: Paraformer's encoder
#: output, the tiny tower's image features and the merged logits (the CPU
#: tests' bound against the JAX package); DeepFilter's frames and waveform
#: relative to max|CPU| (likewise)
PARAFORMER_ENC_ATOL = 1e-5
VISION_ATOL = 1e-5
DEEPFILTER_REL = 1e-5
#: the single-session serve with the backends ported last (before
#: ``tts_flags(..., "facebookMMS")`` and the enhancer's checkpoint):
#: Paraformer-large, SmolLM2-1.7B behind SmolVLM's SigLIP tower
#: (``VisionConfig()``), MMS/VITS for the replies (the ``serve`` phase drives
#: Qwen3-TTS), and DeepFilter on every VAD-final segment
PARAFORMER_VLM_FLAGS = _with(FULL_FLAGS, stt="paraformer", llm_backend="local-vlm")
#: SigLIP's encoder layers: one flash launch each an image
SIGLIP_LAYERS = 12
#: the image sent with the serve's second turn (a PNG this script writes)
IMAGE_SIDE = 96
#: the serve's image turns and text turns, tried in order until one is
#: answered with audio (as ``VOICE_TONES_HZ``: a random-init reply may have
#: nothing to speak); each image attempt must run the tower once
IMAGE_PROMPTS = [("What is in this picture?", "red"), ("Describe the image.", "green"),
                 ("What colors do you see?", "blue"), ("Tell me about this photo.", "red")]
TEXT_PROMPTS = [TEXT, "Tell me a story about the sea.", "How are you today?"]
#: the training phases: the tiny f32 steps on the card against the CPU
#: within TINY_TRAIN_REL x max|CPU| (losses and every parameter leaf); the
#: full-width SmolLM2-1.7B batch (rows, tokens), its AdamW steps and lr
TINY_TRAIN_REL = 1e-5
TRAIN_BATCH = (4, 512)
TRAIN_STEPS = 3
TRAIN_LR = 1e-4
#: the scoring check: ``forward`` over a prompt of SCORE_PROMPT tokens
#: against ``prefill`` of the same prompt, at its last position, within
#: SCORE_ULPS bf16 ulps of max|prefill| (the same layer stack; the head's
#: bf16 product over 1 row or SCORE_PROMPT rows may round otherwise)
SCORE_PROMPT = 100
SCORE_ULPS = 4
#: the converters' parity cases (``convert_cases``): the JAX converters' output
#: on the CPU, by key, dtype, shape and SHA-256 (``array_digests``), written by
#: ``python tests/test_torch_port_convert.py``
CONVERTED_DIGESTS = "tests/data/converted_digests.json"
#: the cases' tiny configs, shared with the CPU test's JAX side: the decoder
#: LM fixtures (``tests/test_torch_parity.py``'s Llama and Qwen3 configs),
#: the Qwen3-TTS talker and code predictor (the ``qwen3tts_parity.npz``
#: predictor's width, the talker drawn at it), its vocoder, Parakeet
LLAMA_FIELDS = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128,
                    rope_theta=10000.0, rms_eps=1e-5, tie_embeddings=True)
QWEN3_FIELDS = dict(LLAMA_FIELDS, rms_eps=1e-6, qk_norm=True, head_dim_override=32)
TTS_CP_FIELDS = dict(vocab_size=1, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq_len=16,
                     rope_theta=10000.0, rms_eps=1e-6, tie_embeddings=False, qk_norm=True, head_dim_override=16)
TTS_LM_FIELDS = dict(TTS_CP_FIELDS, max_seq_len=256)
C2W_FIELDS = dict(codebook_size=64, num_quantizers=4, hidden=32, n_layers=1, n_heads=2, d_ff=64, sliding_window=8,
                  upsampling_ratios=(2, 2), upsample_rates=(4, 3), decoder_dim=32)
TTS_FIELDS = dict(text_vocab=256, codec_vocab=72, codec_bos_id=65, codec_eos_id=66)
PARAKEET_FIELDS = dict(n_mels=32, d_model=64, n_layers=2, n_heads=4, d_ff=128, sub_channels=32, vocab_size=64,
                       pred_hidden=32, pred_layers=1, joint_hidden=32, max_enc_frames=16)
#: the Whisper serve's checkpoints, drawn at the published shapes and dtypes
#: from a torch seed and converted by ``python -m s2s_tpu_torch.tools.convert_checkpoint``:
#: family -> (source file, its dtype); written under CHECKPOINT_DIR (ignored
#: by git) and removed after the serve
CHECKPOINT_DIR = "build/chip_smoke_checkpoints"
CHECKPOINTS = {"smollm2-1.7b": ("smollm2-1.7b.safetensors", torch.bfloat16),
               "distil-large-v3": ("distil-large-v3.safetensors", torch.float16),
               "smart-turn": ("smart-turn.pt", torch.float32)}
CONVERT_TIMEOUT_S = 300
#: tensor parallelism (``--model_parallel``): two ranks.  On one card both
#: run on it and their collectives go through gloo (NCCL takes one card a
#: rank): the rehearsal of a serve over two cards.  With two or more cards
#: visible ``tp_parity`` also runs over NCCL on two of them.
TP_RANKS = 2
TP_REHEARSAL = (("cuda:0",) * TP_RANKS, "gloo")
TP_NCCL = (tuple(f"cuda:{r}" for r in range(TP_RANKS)), "nccl")
#: the tensor-parallel serve: the four-session flags with the talker int8 too
TP_SERVE_FLAGS = [*BATCHED_FLAGS, "--tts_quantize", "int8", "--model_parallel", str(TP_RANKS)]
#: the tiny talker's audio over the ranks against one rank (f32 sums in
#: another order): the JAX package's bound for its sharded talker chunk
#: (``tests/test_sharded_inference.py``)
TP_TALKER_ATOL = 2e-3
#: SmolLM2-1.7B's prefill logits (int8, bf16 activations) over the ranks
#: against one rank on the same weights, relative to max|one rank|: each
#: row-parallel sum rounds every rank's partial to bf16 before the f32 sum,
#: one rounding more than one device's product, 48 times over the layers
TP_LOGITS_REL = 3e-2
#: the all_reduce timed on each transport: four sessions' rows at SmolLM2's width
TP_BLOCK = (4, 2048)
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
def tf32_mode(enabled: bool):
    """TF32 for f32 products and cuDNN's convolutions on or off in the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
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


def png_bytes(rgb: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as a PNG: 8-bit RGB, every row filter type 0."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    rows = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


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
    shapes, row_counts, headline_key = ((INT8_SHAPES + TP_INT8_SHAPES, INT8_ROWS, HEADLINE) if int8
                                        else (INT4_SHAPES, INT4_ROWS, INT4_HEADLINE))
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


def _tp_ranks(fn, layout: tuple):
    """Run ``fn(rank, store, layout)`` on every rank of *layout* (devices,
    transport): rank 0 here, the others in processes of their own
    (``tp_rank_main``) that share a ``TCPStore`` on 127.0.0.1; returns rank
    0's result.  Fails if another rank fails or outlives the ranks' timeout
    (``mesh.TP_TIMEOUT_S``), after which it is killed."""
    import torch.distributed as dist
    from datetime import timedelta

    from s2s_tpu_torch.parallel.mesh import TP_TIMEOUT_S, TPLayout

    tp_layout = TPLayout(*layout)
    store = dist.TCPStore("127.0.0.1", 0, tp_layout.size, True, timeout=timedelta(seconds=TP_TIMEOUT_S),
                          wait_for_workers=False)
    root = os.path.dirname(os.path.abspath(__file__))
    code = (f"import chip_smoke; chip_smoke.tp_rank_main({fn.__name__!r}, {{rank}}, {store.port}, "
            f"{tp_layout.devices!r}, {tp_layout.transport!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code.format(rank=rank)], cwd=root,
                              env=dict(os.environ, PYTHONPATH=root)) for rank in range(1, tp_layout.size)]
    try:
        result = fn(0, store, tp_layout)
        deadline = time.monotonic() + TP_TIMEOUT_S
        for proc in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(all(proc.returncode == 0 for proc in procs), f"{fn.__name__}: ranks exited {[p.returncode for p in procs]}")
    return result


def tp_rank_main(name: str, rank: int, port: int, devices: tuple, transport: str) -> None:
    """A rank of ``_tp_ranks`` in a process of its own."""
    import torch.distributed as dist
    from datetime import timedelta

    from s2s_tpu_torch.parallel.mesh import TP_TIMEOUT_S, TPLayout

    store = dist.TCPStore("127.0.0.1", port, is_master=False, timeout=timedelta(seconds=TP_TIMEOUT_S))
    with tf32_mode(False):
        globals()[name](rank, store, TPLayout(devices, transport))


def _tp_tiny_programs(dev: torch.device, lm_tp, tts_tp) -> dict:
    """The tiny f32 LM's slot prefill and tail chunk, and the tiny talker's
    fused prefill + ramp chunk and a 4-frame gathered chunk, head dim 64 (the
    decode-attention kernel's), on *dev*: over the ranks of the groups, or
    on one device with None.  The weights are drawn from seeds on *dev*."""
    from s2s_tpu_torch.models import decoder_lm, qwen3_tts
    from s2s_tpu_torch.parallel import batched_decode as bd
    from s2s_tpu_torch.registry import _tp_shard_lm

    cfg = decoder_lm.DecoderLMConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256,
                                     max_seq_len=128, head_dim_override=64, dtype=torch.float32)
    params = decoder_lm.init_params(cfg, torch.Generator(device=dev).manual_seed(6), dev)
    if lm_tp is not None:
        params = _tp_shard_lm(params, cfg, lm_tp, "the tp_parity LM")
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(1, 256, (1, 16)).astype(np.int32)).to(dev)
    state = bd.init_multi_state(cfg, 2, max_t=64, device=dev, tp=lm_tp)
    tok, state = bd.prefill_slot(params, cfg, prompt, 12, state, 0, lm_tp)
    tokens = torch.zeros((2,), dtype=torch.int32, device=dev)
    tokens[0] = tok
    toks, _, _, state, _ = bd.decode_chunk_tail(params, cfg, tokens, state, 8, -1,
                                                torch.tensor([True, False], device=dev), lm_tp)

    qcfg = qwen3_tts.Qwen3TTSConfig.tiny()
    qcfg = dataclasses.replace(qcfg, lm=dataclasses.replace(qcfg.lm, head_dim_override=64))
    qparams = qwen3_tts.init_params(qcfg, torch.Generator(device=dev).manual_seed(7), dev)
    if tts_tp is not None:
        qparams = dict(qparams, talker=_tp_shard_lm(qparams["talker"], qcfg.lm, tts_tp, "the tp_parity talker",
                                                    talker=True))
    text = torch.from_numpy(rng.integers(1, 256, (1, 16)).astype(np.int32)).to(dev)
    tstate = bd.init_multi_state(qcfg.lm, 2, max_t=64, device=dev, tp=tts_tp)
    ctx = torch.zeros((2, 4, qcfg.n_q), dtype=torch.int32, device=dev)
    embeds = torch.zeros((2, qcfg.lm.d_model), device=dev)
    first, _, emb, tstate, ctx = qwen3_tts.prefill_and_first_chunk_slot_tail(
        qparams, qcfg, text, qparams["speakers"][:1], tstate, ctx, 2, 0, tts_tp)
    embeds[0] = emb
    chunk, eos, embeds, tstate, ctx = qwen3_tts.decode_chunk_audio_gathered_tail(
        qparams, qcfg, embeds, tstate, ctx, 4, torch.tensor([0, 0], device=dev), tts_tp)
    return {"lm_tokens": toks[:, 0].cpu(), "talker_audio": torch.cat([first, chunk[0]]).cpu(),
            "talker_codes": ctx[0].cpu()}


def _all_reduce_us(tp, dev: torch.device, calls: int = 200) -> float:
    """Wall microseconds of one ``all_reduce`` of a TP_BLOCK bf16 block
    (summed in f32), every rank calling it *calls* times after a warm-up."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    x = torch.randn(TP_BLOCK, device=dev).to(torch.bfloat16)
    for _ in range(20):
        tp.all_reduce(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        tp.all_reduce(x)
    sync()
    return (time.perf_counter() - t0) / calls * 1e6


def _tp_logits(dev: torch.device, tp) -> dict:
    """SmolLM2-1.7B drawn as the serve draws it (``registry._random_init``,
    seed 0 on the card), int8, a 64-token prompt's prefill logits (f32) at
    its last position: over the ranks of *tp* on their shards, and on rank 0
    also of the whole tree on its own ("one")."""
    from s2s_tpu_torch.llm.local_backend import lm_config
    from s2s_tpu_torch.models import decoder_lm
    from s2s_tpu_torch.ops.quant import quantize_mode
    from s2s_tpu_torch.parallel import batched_decode as bd
    from s2s_tpu_torch.registry import _random_init, _tp_shard_lm

    cfg = lm_config("smollm2-1.7b")
    whole = quantize_mode(_random_init(decoder_lm.init_params, cfg, dev, "tp_parity logits"), "int8")
    prompt = torch.from_numpy(np.random.default_rng(8).integers(1, cfg.vocab_size, (1, 64)).astype(np.int32))

    def logits(params, group):
        row = bd._slot_row(bd.init_multi_state(cfg, 1, max_t=128, device=dev, tp=group), 0)
        x = decoder_lm.embed_tokens(params["embed"], prompt.to(dev), cfg, group).to(cfg.dtype)
        hidden = bd._prefill_row_caches(params, cfg, x, row, group)
        return decoder_lm._logits(hidden[:, -1:], params, cfg, group)[0, 0].cpu()

    out = {"tp": logits(_tp_shard_lm(whole, cfg, tp, "--llm_model_size smollm2-1.7b"), tp)}
    if tp.rank == 0:
        out["one"] = logits(whole, None)
    return out


def tp_parity_rank(rank: int, store, layout) -> dict:
    """One rank of ``tp_parity``: the tiny programs over the ranks, the
    full-width LM's prefill logits (``_tp_logits``), then the transport's
    all_reduce time; rank 0 returns them."""
    from s2s_tpu_torch.parallel.mesh import TPRuntime

    runtime = TPRuntime(rank, layout, store)
    try:
        out = _tp_tiny_programs(runtime.device, runtime.group("lm"), runtime.group("tts"))
        out["collectives"] = {name: g.collectives for name, g in runtime.groups.items()}
        out["logits"] = _tp_logits(runtime.device, runtime.group("lm"))
        out["all_reduce_us"] = _all_reduce_us(runtime.group("lm"), runtime.device)
    finally:
        runtime.shutdown()
    return out


def tp_parity_phase(dev: torch.device) -> dict:
    """``tp_parity``: the tiny f32 LM and talker programs over TP_RANKS
    ranks, both on this card through gloo (``TP_REHEARSAL``), against the
    same programs on one rank of the card: LM tokens equal, talker codes
    equal and audio within TP_TALKER_ATOL; SmolLM2-1.7B's int8 prefill
    logits over the ranks against one rank within TP_LOGITS_REL of
    max|one|; each transport's all_reduce time.  With two or more cards, the
    same over NCCL on two cards."""
    from s2s_tpu_torch.ops import decode_attention as da

    ref = _tp_tiny_programs(dev, None, None)
    layouts = [TP_REHEARSAL] + ([TP_NCCL] if torch.cuda.device_count() >= TP_RANKS else [])
    result = {}
    for devices, transport in layouts:
        before = da.concat_attention.launches
        got = _tp_ranks(tp_parity_rank, (devices, transport))
        where = f"tp_parity over {transport} on {devices}"
        check(torch.equal(got["lm_tokens"], ref["lm_tokens"]), f"{where}: LM tokens {got['lm_tokens']} vs "
              f"{ref['lm_tokens']} on one rank")
        check(torch.equal(got["talker_codes"], ref["talker_codes"]), f"{where}: talker codes")
        err = float((got["talker_audio"] - ref["talker_audio"]).abs().max())
        check(got["talker_audio"].shape == ref["talker_audio"].shape and err <= TP_TALKER_ATOL,
              f"{where}: talker audio |d| {err} > {TP_TALKER_ATOL}")
        launches = da.concat_attention.launches - before
        check(launches > 0, f"{where}: rank 0 launched no decode attention")
        tp_logits, one = got["logits"]["tp"], got["logits"]["one"]
        rel = float((tp_logits - one).abs().max() / one.abs().max())
        check(bool(torch.isfinite(tp_logits).all()) and rel <= TP_LOGITS_REL,
              f"{where}: SmolLM2-1.7B prefill logits over the ranks vs one: rel {rel} > {TP_LOGITS_REL}")
        result[transport] = {"devices": list(devices), "lm_tokens": got["lm_tokens"].tolist(),
                             "talker_audio_max_abs_err": err, "atol": TP_TALKER_ATOL,
                             "rank0_decode_attention_launches": launches, "collectives": got["collectives"],
                             "prefill_logits": {"max_rel_err": rel, "rtol": TP_LOGITS_REL,
                                                "argmax_equal": int(tp_logits.argmax()) == int(one.argmax())},
                             "all_reduce_us": got["all_reduce_us"], "block": list(TP_BLOCK)}
    phase("tp_parity", **result)
    return result


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


def _text_turn(text: str, response: dict | None = None):
    return [
        (0, {"type": "conversation.item.create", "item": {
            "type": "message", "role": "user", "content": [{"type": "input_text", "text": text}]}}),
        (0, {"type": "response.create", "response": response or {}}),
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
    turn and a voice turn, then the ``talk`` client's voice turn against the
    same server (``talk_phase``); returns the int8 kernel's and the Parakeet
    frontend's launches over the measured turns."""
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
        talk_phase(url, server.pool)
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
    """A voice turn: its transcription, then the reply's ``response.done``;
    with no reply audio, 5 s after an empty transcript (which starts no
    reply) or 20 s after another, the end of the attempt."""
    transcripts = _transcripts(events)
    if not transcripts:
        return False
    if "response.output_audio.delta" in _types(events):
        return "response.done" in _types(events)
    return now - transcripts[0][0] > (20.0 if transcripts[0][1].strip() else 5.0)


def _voice_turns(url: str, what: str, need_words: bool) -> tuple[list | None, list[dict]]:
    """Voice turns at ``VOICE_TONES_HZ`` until one is answered with audio:
    (that turn's events or None, one summary an attempt).  Each must be
    transcribed, with a non-empty transcript if *need_words*."""
    attempts = []
    for tone in VOICE_TONES_HZ:
        events = asyncio.run(_session(url, _audio_turn(tone), _reply_or_quiet, 300))
        transcripts = _transcripts(events)
        check(len(transcripts) >= 1 and (not need_words or transcripts[0][1].strip() != ""),
              f"{what} voice turn at {tone} Hz: a {'non-empty ' if need_words else ''}transcription ({transcripts})")
        replied = "response.output_audio.delta" in _types(events)
        attempts.append({"tone_hz": tone, "transcript": transcripts[0][1][:80], "replied": replied})
        if replied:
            return events, attempts
    return None, attempts


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


def tp_serve_phase(dev: torch.device, card: list[str], parity: dict) -> dict[str, int]:
    """``tp_serve``: the 4-session batched serve at full width and depth with
    ``--tts_quantize int8 --model_parallel 2`` (``TP_SERVE_FLAGS``), both
    ranks on this card through gloo (``TP_REHEARSAL``, a rehearsal: not TP's
    speed on two cards).  On a one-card machine ``serve --model_parallel 2``
    on its own must first raise the device-count error.  Then the serve's
    build (its warm-up mirrored on the follower), one concurrent round of
    four text turns, each answered with audio and response.done, and an
    audio turn.  The int8 and decode-attention kernels' launches on each
    rank from the build to the end (each > 0, equal across ranks), each
    rank's allocated bytes after a collection (the leader's also above
    what it held before the build), and each engine's replicated state equal on
    every rank at the end.  Its line repeats *parity*'s (``tp_parity``'s)
    SmolLM2-1.7B prefill logits and all_reduce time on the transport."""
    from s2s_tpu_torch import builder, cli
    from s2s_tpu_torch.ops import decode_attention as da
    from s2s_tpu_torch.ops import int8_matmul as mm
    from s2s_tpu_torch.parallel.mesh import TPLayout, rank_report
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    refused = None
    if torch.cuda.device_count() < TP_RANKS:
        try:
            cli.run_serve(["--device", "cuda", *TP_SERVE_FLAGS])
        except RuntimeError as e:
            refused = str(e)
        check(refused is not None and f"needs {TP_RANKS} devices; {torch.cuda.device_count()} visible" in refused,
              f"serve --model_parallel {TP_RANKS} on {torch.cuda.device_count()} card(s): {refused}")

    rehearsal = parity[TP_REHEARSAL[1]]
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)  # what earlier phases left: the leader's serve is read above it
    mm.int8_matmul.launches = da.concat_attention.launches = 0  # from the build: the follower counts from its start
    stop = threading.Event()
    t0 = time.perf_counter()
    manager, server, _ = cli.build_from_argv(["--device", "cuda", *TP_SERVE_FLAGS], stop,
                                             tp_layout=TPLayout(*TP_REHEARSAL))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    handler = builder.tp_handler_of(manager)
    check(handler is not None, "the serve holds a tensor-parallel runtime")
    runtime = handler.runtime
    manager.start()
    try:
        check(server.started.wait(60), "server started")
        url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"
        t0 = time.perf_counter()
        rounds = asyncio.run(_concurrent_text_turns(url, SESSIONS))
        round_s = time.perf_counter() - t0
        audio = asyncio.run(_session(url, _audio_turn(), _transcribed_and_settled, 600))
    finally:
        stop.set()
        manager.stop()
        handler.close()
        leader = rank_report(dev)
        consistent = runtime.consistent()
        GLOBAL_MODEL_CACHE.clear()

    sessions = []
    for i, events in enumerate(rounds):
        pcm, done = _reply(events, f"tp_serve text turn {i}")
        sessions.append({"ttfa_s": _first_audio_s(events), "turn_s": done, "audio_seconds": pcm.size / 24_000})
    voice = _voice_summary(audio)
    followers = [runtime.follower_reports.get(rank) for rank in range(1, runtime.size)]
    check(all(r is not None for r in followers), "every follower reported its launches and memory")
    ranks = [leader, *followers]
    for name in ("int8_matmul", "decode_attention"):
        counts = [r["launches"][name] for r in ranks]
        check(all(c > 0 for c in counts) and len(set(counts)) == 1, f"tp_serve {name} launches by rank {counts}")
    check(all(consistent.values()) and set(consistent) == {"lm", "tts"},
          f"tp_serve: the followers' replicated state equals the leader's: {consistent}")
    shared = len(set(runtime.layout.devices)) < runtime.size
    result = {"card": card,
              "rehearsal": "ranks share a card: not tensor parallelism's speed on several" if shared else None,
              "transport": runtime.layout.transport, "devices": list(runtime.layout.devices),
              "flags": TP_SERVE_FLAGS[len(BATCHED_FLAGS):], "refused_on_one_card": refused,
              "prefill_logits": rehearsal["prefill_logits"], "all_reduce_us": rehearsal["all_reduce_us"],
              "block": list(TP_BLOCK),
              "build_s": build_s, "round_s": round_s, "text_turns": sessions, "voice_turn": voice,
              "launches_by_rank": [r["launches"] for r in ranks],
              "allocated_bytes_by_rank": [r.get("allocated_bytes") for r in ranks],
              "leader_allocated_before_bytes": before,
              "serve_allocated_bytes_by_rank": [leader["allocated_bytes"] - before,
                                                *(r.get("allocated_bytes") for r in followers)],
              "max_allocated_bytes_by_rank": [r.get("max_allocated_bytes") for r in ranks],
              "replicated_state_equal": consistent}
    phase("tp_serve", **result)
    return {name: [r["launches"][name] for r in ranks] for name in ("int8_matmul", "decode_attention")}


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
    rows, max_err, headline, siglip, d, calls = [], 0.0, None, None, 64, 20
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
        if (name, h, t, causal) == FLASH_SIGLIP:
            siglip = row
    check(headline is not None and siglip is not None, "flash_attention headline and SigLIP shapes measured")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"max_abs_err": max_err, **{key: headline[key] for key in keys},
            "siglip": {key: siglip[key] for key in ("H", "T", "D", "max_abs_err", *keys)}}


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


# ── checkpoint conversion ────────────────────────────────────────────


def fixture_state_dict(name: str) -> dict[str, np.ndarray]:
    """``tests/data/<name>_parity.npz``'s source state dict: its ``sd__``
    entries, as ``tests/test_torch_parity.py::load_fixture`` reads them."""
    data = np.load(f"tests/data/{name}_parity.npz")
    return {k[len("sd__"):]: data[k] for k in data.files if k.startswith("sd__")}


def _drawer(gen: torch.Generator, dtype: torch.dtype):
    """Weights N(0, 0.02) and norm gains 1 + N(0, 0.1) in *dtype* on *gen*'s device."""
    def w(*shape):
        return (torch.randn(shape, generator=gen, device=gen.device) * 0.02).to(dtype)

    def gain(n):
        return (1.0 + 0.1 * torch.randn((n,), generator=gen, device=gen.device)).to(dtype)

    return w, gain


def hf_decoder_lm_state_dict(cfg, gen: torch.Generator, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """A Hugging Face Llama state dict (Qwen3's, with ``cfg.qk_norm``) at
    *cfg*'s shapes in *dtype*, on *gen*'s device; ``lm_head.weight`` unless
    the embeddings are tied (SmolLM2 ties them)."""
    w, gain = _drawer(gen, dtype)
    d, hd = cfg.d_model, cfg.head_dim
    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = gain(d)
        sd[p + "self_attn.q_proj.weight"] = w(cfg.n_heads * hd, d)
        sd[p + "self_attn.k_proj.weight"] = w(cfg.n_kv_heads * hd, d)
        sd[p + "self_attn.v_proj.weight"] = w(cfg.n_kv_heads * hd, d)
        sd[p + "self_attn.o_proj.weight"] = w(d, cfg.n_heads * hd)
        if cfg.qk_norm:
            sd[p + "self_attn.q_norm.weight"] = gain(hd)
            sd[p + "self_attn.k_norm.weight"] = gain(hd)
        sd[p + "post_attention_layernorm.weight"] = gain(d)
        sd[p + "mlp.gate_proj.weight"] = w(cfg.d_ff, d)
        sd[p + "mlp.up_proj.weight"] = w(cfg.d_ff, d)
        sd[p + "mlp.down_proj.weight"] = w(d, cfg.d_ff)
    sd["model.norm.weight"] = gain(d)
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = w(cfg.vocab_size, d)
    return sd


def hf_whisper_state_dict(cfg, gen: torch.Generator, dtype: torch.dtype, prefix: str = "model.",
                          encoder_only: bool = False) -> dict[str, torch.Tensor]:
    """A transformers ``WhisperForConditionalGeneration`` state dict at
    *cfg*'s shapes in *dtype* on *gen*'s device (the encoder alone with
    *encoder_only*, its keys under ``<prefix>encoder.``)."""
    w, gain = _drawer(gen, dtype)
    d = cfg.d_model

    def norm(p):
        return {p + "weight": gain(d), p + "bias": w(d)}

    def attn(p):
        return {p + "q_proj.weight": w(d, d), p + "q_proj.bias": w(d), p + "k_proj.weight": w(d, d),
                p + "v_proj.weight": w(d, d), p + "v_proj.bias": w(d),
                p + "out_proj.weight": w(d, d), p + "out_proj.bias": w(d)}

    def block(p, cross):
        out = {**norm(p + "self_attn_layer_norm."), **attn(p + "self_attn."), **norm(p + "final_layer_norm."),
               p + "fc1.weight": w(4 * d, d), p + "fc1.bias": w(4 * d),
               p + "fc2.weight": w(d, 4 * d), p + "fc2.bias": w(d)}
        if cross:
            out.update({**norm(p + "encoder_attn_layer_norm."), **attn(p + "encoder_attn.")})
        return out

    e = prefix + "encoder."
    sd = {e + "conv1.weight": w(d, cfg.n_mels, 3), e + "conv1.bias": w(d),
          e + "conv2.weight": w(d, d, 3), e + "conv2.bias": w(d),
          e + "embed_positions.weight": w(cfg.n_audio_ctx, d)}
    for i in range(cfg.n_enc_layers):
        sd.update(block(f"{e}layers.{i}.", False))
    sd.update(norm(e + "layer_norm."))
    if not encoder_only:
        t = prefix + "decoder."
        sd.update({t + "embed_tokens.weight": w(cfg.vocab_size, d), t + "embed_positions.weight": w(cfg.n_text_ctx, d)})
        for i in range(cfg.n_dec_layers):
            sd.update(block(f"{t}layers.{i}.", True))
        sd.update(norm(t + "layer_norm."))
    return sd


def smart_turn_state_dict(cfg, gen: torch.Generator, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Smart Turn's checkpoint: a Whisper encoder under ``encoder.`` and its
    ``classifier`` head over the pooled output."""
    w, _ = _drawer(gen, dtype)
    sd = hf_whisper_state_dict(cfg, gen, dtype, prefix="", encoder_only=True)
    return {**sd, "classifier.weight": w(1, cfg.d_model), "classifier.bias": w(1)}


def silero_state_dict(seed: int = 0) -> dict[str, np.ndarray]:
    """silero-vad v5's state dict at its published shapes (the four
    re-parametrized convolutions, the LSTM cell, the 1x1 head), from a numpy
    seed."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    sd = {}
    for i, (cin, cout) in enumerate(((129, 128), (128, 64), (64, 64), (64, 128))):
        sd[f"_model.encoder.{i}.reparam_conv.weight"] = w(cout, cin, 3)
        sd[f"_model.encoder.{i}.reparam_conv.bias"] = w(cout)
    for name, shape in (("weight_ih", (512, 128)), ("weight_hh", (512, 128)), ("bias_ih", (512,)),
                        ("bias_hh", (512,))):
        sd[f"_model.decoder.rnn.{name}"] = w(*shape)
    sd["_model.decoder.decoder.2.weight"] = w(1, 128, 1)
    sd["_model.decoder.decoder.2.bias"] = w(1)
    return sd


def smart_turn_fixture_state_dict() -> dict[str, np.ndarray]:
    """The Whisper fixture's encoder plus a seeded classifier, as
    ``tests/test_torch_parity.py::test_smart_turn_converter_and_head``."""
    sd = {k: v for k, v in fixture_state_dict("whisper").items() if ".encoder." in k}
    rng = np.random.RandomState(0)
    sd["classifier.weight"] = rng.randn(1, 64).astype(np.float32) * 0.1
    sd["classifier.bias"] = np.asarray([0.2], np.float32)
    return sd


def qwen3_tts_fixture_state_dict() -> dict[str, np.ndarray]:
    """A whole Qwen3-TTS checkpoint at ``TTS_*_FIELDS``: the code predictor
    and vocoder of ``qwen3tts_parity.npz`` (transformers' modules), a talker
    at the predictor's width drawn under Qwen3's names (its embedding rows
    the codec vocabulary, its head as ``codec_head``) and a text embedding;
    the speaker tables are absent, so the converter's zero defaults run."""
    from s2s_tpu_torch.models.decoder_lm import DecoderLMConfig

    cfg = DecoderLMConfig(**dict(TTS_LM_FIELDS, vocab_size=TTS_FIELDS["codec_vocab"]))
    gen = torch.Generator().manual_seed(3)
    talker = hf_decoder_lm_state_dict(cfg, gen, torch.float32)
    sd = {("talker.codec_head.weight" if k == "lm_head.weight" else "talker." + k): v.numpy()
          for k, v in talker.items()}
    sd["talker.text_embed.weight"] = (torch.randn((TTS_FIELDS["text_vocab"], cfg.d_model), generator=gen)
                                      * 0.02).numpy()
    return {**sd, **fixture_state_dict("qwen3tts")}


def convert_cases() -> dict:
    """The converters' parity cases: name -> (the source state dict's maker,
    the port's converter on (state dict, device)).  Every ``--family`` of
    the conversion tool reaches one of these converters; the fixtures' tiny
    configs, f32, and bf16 configs of the decoder LM, Whisper, Qwen3-TTS and
    Parakeet.  ``tests/test_torch_port_convert.py`` holds each against the
    JAX converter with the same config."""
    from s2s_tpu_torch.models import (
        chattts, decoder_lm, deepfilter, kokoro, mimi, paraformer, parakeet, pocket_tts, qwen3_tts, silero_vad,
        vision, vits, whisper,
    )
    from s2s_tpu_torch.vad import smart_turn

    f32, bf16 = torch.float32, torch.bfloat16

    def lm(fields, dtype):
        return decoder_lm.DecoderLMConfig(**fields, dtype=dtype)

    def tts(dtype):
        return qwen3_tts.Qwen3TTSConfig(**TTS_FIELDS, lm=lm(TTS_LM_FIELDS, dtype), cp=lm(TTS_CP_FIELDS, dtype),
                                        c2w=qwen3_tts.Code2WavConfig(**C2W_FIELDS, dtype=dtype), dtype=dtype)

    def whisper_tiny(dtype):
        return dataclasses.replace(whisper.WhisperConfig.test_tiny(), dtype=dtype)

    def fixture(name):
        return lambda: fixture_state_dict(name)

    cases = {}
    for suffix, dt in (("", f32), ("-bf16", bf16)):
        cases.update({
            f"llama{suffix}": (fixture("llama"), lambda sd, d, dt=dt: decoder_lm.convert_hf_state_dict(
                sd, lm(LLAMA_FIELDS, dt), d)),
            f"whisper{suffix}": (fixture("whisper"), lambda sd, d, dt=dt: whisper.convert_hf_state_dict(
                sd, whisper_tiny(dt), device=d)),
            f"qwen3-tts{suffix}": (qwen3_tts_fixture_state_dict, lambda sd, d, dt=dt: qwen3_tts.convert_state_dict(
                sd, tts(dt), d)),
            f"parakeet{suffix}": (fixture("parakeet"), lambda sd, d, dt=dt: parakeet.convert_state_dict(
                sd, parakeet.ParakeetConfig(**PARAKEET_FIELDS, dtype=dt), d)),
        })
    cases.update({
        "qwen3": (fixture("qwen3"), lambda sd, d: decoder_lm.convert_hf_state_dict(sd, lm(QWEN3_FIELDS, f32), d)),
        "smart-turn": (smart_turn_fixture_state_dict,
                       lambda sd, d: smart_turn.convert_state_dict(sd, whisper_tiny(f32), d)),
        "silero-vad": (silero_state_dict, silero_vad.convert_silero_state_dict),
        "paraformer": (fixture("paraformer"), lambda sd, d: paraformer.convert_state_dict(
            sd, paraformer.ParaformerConfig.test_tiny(), d)),
        "smolvlm-vision": (fixture("smolvlm"), lambda sd, d: vision.convert_hf_state_dict(
            sd, vision.VisionConfig.test_tiny(), d)),
        "mms-vits": (fixture("vits"), lambda sd, d: vits.convert_hf_state_dict(sd, vits.VitsConfig.test_tiny(), d)),
        "kokoro": (fixture("kokoro"), lambda sd, d: kokoro.convert_state_dict(sd, kokoro.KokoroConfig.test_tiny(), d)),
        "mimi": (fixture("mimi"), lambda sd, d: mimi.convert_state_dict(sd, mimi.MimiConfig.tiny(), d)),
        "mimi-hf": (fixture("mimi_hf"), lambda sd, d: mimi.convert_hf_state_dict(sd, mimi.MimiConfig.tiny(), d)),
        "pocket-tts": (fixture("pocket"), lambda sd, d: pocket_tts.convert_state_dict(
            sd, pocket_tts.PocketTTSConfig.tiny(), d)),
        "chattts": (fixture("chattts"), lambda sd, d: chattts.convert_state_dict(sd, chattts.ChatTTSConfig.tiny(), d)),
        "deepfilter": (fixture("deepfilter"), lambda sd, d: deepfilter.convert_state_dict(
            sd, deepfilter.DeepFilterConfig.tiny(), d)),
    })
    return cases


def array_digests(flat: dict[str, np.ndarray]) -> list[list]:
    """[key, dtype, shape, SHA-256 of the bytes] of each array of a
    flattened checkpoint, in key order."""
    import hashlib

    return [[k, v.dtype.str, list(v.shape), hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()]
            for k, v in sorted(flat.items())]


def _tree_devices(tree) -> set[str]:
    return {str(leaf.device) for leaf in pytree.tree_leaves(tree) if isinstance(leaf, torch.Tensor)}


def convert_parity_phase(dev: torch.device) -> None:
    """Every converter on the card against the JAX converters: each case of
    ``convert_cases`` converted with ``device=dev`` (every leaf must land
    there), flattened by the conversion tool and compared by
    ``array_digests`` with ``CONVERTED_DIGESTS``; then F32, F16 and BF16
    safetensors files (with I64 and BOOL entries) through the tool's writer
    and reader, bit for bit."""
    from s2s_tpu_torch.tools import convert_checkpoint as cc

    with open(CONVERTED_DIGESTS) as f:
        want = json.load(f)
    cases = convert_cases()
    check(sorted(cases) == sorted(want), f"the digests cover the cases: {sorted(cases)} vs {sorted(want)}")
    mismatched, arrays = {}, 0
    t0 = time.perf_counter()
    for name, (make, convert) in cases.items():
        tree = convert(make(), dev)
        check(_tree_devices(tree) == {str(dev)}, f"{name}: converted on {dev}: {_tree_devices(tree)}")
        got = array_digests(cc.flatten(tree))
        arrays += len(got)
        if got != want[name]:
            keys = {row[0]: row for row in want[name]}
            mismatched[name] = [row for row in got if keys.get(row[0]) != row][:3] or "missing keys"
    convert_s = time.perf_counter() - t0
    check(not mismatched, f"the converters on the card give the JAX converters' arrays: {mismatched}")
    gen = torch.Generator(device=dev).manual_seed(11)
    round_trips = {}
    os.makedirs(CHECKPOINT_DIR, exist_ok=True)
    for dt in (torch.float32, torch.float16, torch.bfloat16):
        tensors = {"w": torch.randn((37, 5), generator=gen, device=dev).to(dt),
                   "ids": torch.randint(-(1 << 40), 1 << 40, (9,), generator=gen, device=dev),
                   "mask": torch.rand((3, 4), generator=gen, device=dev) > 0.5}
        path = os.path.join(CHECKPOINT_DIR, f"round_trip_{str(dt)[6:]}.safetensors")
        cc.save_safetensors(path, tensors)
        back = cc.SafetensorsFile(path)
        same = sorted(back) == sorted(tensors) and all(
            back[k].dtype == t.dtype and torch.equal(back[k], t.cpu()) for k, t in tensors.items())
        check(same, f"safetensors {dt}: the reader gives back what the writer wrote")
        round_trips[str(dt)[6:]] = os.path.getsize(path)
        os.remove(path)
    phase("convert_parity", cases=len(cases), arrays=arrays, bf16_cases=sorted(k for k in cases if "bf16" in k),
          convert_s=convert_s, safetensors_round_trip_bytes=round_trips)


def write_serve_checkpoints(dev: torch.device) -> dict[str, dict]:
    """The Whisper serve's sources (``CHECKPOINTS``) at the published shapes
    and dtypes, drawn on the card from torch seeds and written under
    ``CHECKPOINT_DIR`` by the conversion tool's safetensors writer (the LM and
    Whisper) or ``torch.save`` (Smart Turn); then each converted by the tool
    on the card, as a user runs it, the three subprocesses at once.  Returns,
    per family, the source and output paths, their bytes, the source's draw
    and write seconds, the conversion's seconds (its process's start to its
    end, polled every 50 ms) and the tool's peak RSS and its RSS before
    converting (the CUDA context included)."""
    import re

    from s2s_tpu_torch.models.decoder_lm import DecoderLMConfig
    from s2s_tpu_torch.models.whisper import WhisperConfig
    from s2s_tpu_torch.tools import convert_checkpoint as cc

    os.makedirs(CHECKPOINT_DIR, exist_ok=True)
    makers = {
        "smollm2-1.7b": lambda gen, dt: hf_decoder_lm_state_dict(DecoderLMConfig.smollm2_1_7b(), gen, dt),
        "distil-large-v3": lambda gen, dt: hf_whisper_state_dict(WhisperConfig.distil_large_v3(), gen, dt),
        "smart-turn": lambda gen, dt: smart_turn_state_dict(WhisperConfig.tiny(), gen, dt),
    }
    out, procs = {}, {}
    for seed, (family, (name, dtype)) in enumerate(CHECKPOINTS.items()):
        src = os.path.join(CHECKPOINT_DIR, name)
        t0 = time.perf_counter()
        sd = makers[family](torch.Generator(device=dev).manual_seed(100 + seed), dtype)
        if src.endswith(".safetensors"):
            cc.save_safetensors(src, sd)
        else:
            torch.save({k: v.cpu() for k, v in sd.items()}, src)
        out[family] = {"src": src, "out": os.path.join(CHECKPOINT_DIR, family + ".npz"),
                       "draw_write_s": time.perf_counter() - t0}
        del sd
    for family, f in out.items():  # the three conversions at once, a process each, its output to a file
        with open(f["out"] + ".log", "w") as log:
            procs[family] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "s2s_tpu_torch.tools.convert_checkpoint", "--family", family,
                 "--src", f["src"], "--out", f["out"]], stdout=log, stderr=subprocess.STDOUT, text=True))
    try:
        while any(proc.poll() is None for _, proc in procs.values()):
            check(time.perf_counter() - min(t0 for t0, _ in procs.values()) < CONVERT_TIMEOUT_S,
                  f"the conversions ended within {CONVERT_TIMEOUT_S} s")
            for family, (t0, proc) in procs.items():
                if "convert_s" not in out[family] and proc.poll() is not None:
                    out[family]["convert_s"] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for family, (t0, proc) in procs.items():
        out[family].setdefault("convert_s", time.perf_counter() - t0)
        with open(out[family]["out"] + ".log") as log:
            printed = log.read()
        check(proc.returncode == 0, f"convert_checkpoint --family {family}: {printed[-2000:]}")
        m = re.search(r"wrote .*: (\d+) arrays, ([\d.]+)M params, peak RSS ([\d.]+) MiB \(([\d.]+) MiB before",
                      printed)
        check(m is not None, f"convert_checkpoint --family {family} printed its counts: {printed[-500:]}")
        out[family].update(src_bytes=os.path.getsize(out[family]["src"]), out_bytes=os.path.getsize(out[family]["out"]),
                           arrays=int(m.group(1)), params_m=float(m.group(2)), peak_rss_mib=float(m.group(3)),
                           start_rss_mib=float(m.group(4)))
    return out


def check_served_weights(files: dict[str, dict], llm_params, whisper_params) -> dict:
    """The spot checks of the served weights against their sources: the
    LM's embedding bit for bit; its projections int8 (``QuantWeight``), layer
    0's ``wv`` in the converted file equal to ``v_proj`` transposed and the
    served ``wv`` within half a quantization step of it (every layer's ``wq``
    too, whose rows the converter permutes); Whisper's ``conv1_w`` in the
    file the source conv transposed (2, 1, 0), served (as Conv1d) equal to
    the source.  Returns the largest dequantization error in steps."""
    from s2s_tpu_torch.ops.quant import QuantWeight
    from s2s_tpu_torch.tools import convert_checkpoint as cc

    lm_src = cc.SafetensorsFile(files["smollm2-1.7b"]["src"])
    lm_npz = np.load(files["smollm2-1.7b"]["out"])
    embed = lm_src["model.embed_tokens.weight"]
    check(torch.equal(llm_params["embed"].cpu(), embed), "the served embed is the source's, bit for bit")
    layers = llm_params["layers"]
    quant = {k: type(v).__name__ for k, v in layers.items() if "norm" not in k}
    check(all(isinstance(layers[k], QuantWeight) for k in quant), f"the served LM's projections are int8: {quant}")
    v_src = lm_src["model.layers.0.self_attn.v_proj.weight"]
    wv0 = torch.from_numpy(lm_npz["layers/wv"][0].view(np.int16)).view(torch.bfloat16)
    check(torch.equal(wv0, v_src.T), "layer 0's wv in the converted file is v_proj transposed, bit for bit")
    steps = {}
    for name in ("wq", "wv", "w_down"):
        qw = layers[name]
        src = torch.from_numpy(lm_npz[f"layers/{name}"].view(np.int16)).view(torch.bfloat16).to(qw.q.device)
        scale = qw.scale.float()[:, None, :]
        steps[name] = float(((qw.q.float() * scale - src.float()).abs() / scale).max())
        del src, scale
    w_src = cc.SafetensorsFile(files["distil-large-v3"]["src"])["model.encoder.conv1.weight"]
    w_npz = np.load(files["distil-large-v3"]["out"])["conv1_w"]
    check(np.array_equal(w_npz.view(np.int16), w_src.to(torch.bfloat16).view(torch.int16).numpy().transpose(2, 1, 0)),
          "Whisper's conv1_w in the converted file is the source conv transposed (2, 1, 0), cast to bf16")
    check(torch.equal(whisper_params["conv1_w"].cpu(), w_src.to(torch.bfloat16)),
          "the served conv1 weight is the source's, as Conv1d, cast to bf16")
    return steps


class _Lines(logging.Handler):
    """Keeps the log records it is handed."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.records: list[logging.LogRecord] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)


def whisper_serve_phase(dev: torch.device, card: list[str]) -> dict[str, int]:
    """The single-session serve with Whisper distil-large-v3 and Smart Turn
    (``WHISPER_FLAGS``) from checkpoints the conversion tool wrote
    (``write_serve_checkpoints``: SmolLM2-1.7B, distil-large-v3, Smart Turn),
    so the LM is int8: build (the STT handler warms Whisper up; each
    checkpoint load timed), then every count set to 0, one text turn and the
    voice turns.  Smart Turn's predictions and the Whisper and Smart Turn
    encodes are counted by wrapping ``SmartTurnAnalyzer.predict`` and
    ``whisper.encode``; the VAD handler would log a failed prediction and
    carry on, so failures are counted and its log watched.  Then the served
    weights' spot checks (``check_served_weights``) and a ``checkpoint``
    line.  Returns each kernel's launches over the two turns, the int8 ones
    on the LM's weights also as ``int8_matmul_lm``."""
    import shutil

    from s2s_tpu_torch import cli, registry
    from s2s_tpu_torch.models import common, whisper
    from s2s_tpu_torch.ops import _build
    from s2s_tpu_torch.ops import int8_matmul as mm
    from s2s_tpu_torch.ops.quant import QuantWeight
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE
    from s2s_tpu_torch.vad import smart_turn

    files = write_serve_checkpoints(dev)
    flags = [*WHISPER_FLAGS, "--llm_checkpoint", files["smollm2-1.7b"]["out"],
             "--stt_checkpoint", files["distil-large-v3"]["out"],
             "--vad_smart_turn_checkpoint", files["smart-turn"]["out"]]
    real_load, load_s = registry._load_checkpoint, {}
    # the int8 launches on the LM's own weights (the talker and code predictor are int8 too): a linear on
    # one of them marks its thread while it runs, and a launch counted in a marked thread is the LM's
    real_linear, real_count, lm_q, lm_launches, marked = common.quantized_linear, _build.count_launch, [], [0], \
        threading.local()

    def lm_linear(x, qw, b=None):
        marked.lm = any(lo <= qw.q.data_ptr() < hi for lo, hi in lm_q)
        try:
            return real_linear(x, qw, b)
        finally:
            marked.lm = False

    def lm_count(wrapper, rows=None):
        real_count(wrapper, rows)
        if wrapper is mm.int8_matmul and getattr(marked, "lm", False):
            lm_launches[0] += 1

    def timed_load(path):
        t0 = time.perf_counter()
        tree = real_load(path)
        if path:
            load_s[os.path.basename(path)] = time.perf_counter() - t0
        return tree

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
    registry._load_checkpoint = timed_load
    stop = threading.Event()
    try:
        t0 = time.perf_counter()
        manager, server, _ = cli.build_from_argv(["--device", "cuda", *flags], stop)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        registry._load_checkpoint = real_load
        served = {type(h).__name__: h for h in manager.handlers}
        llm_params = served["LocalTorchLLMHandler"].params
        whisper_params = served["WhisperSTTHandler"]._whisper_params
        lm_q[:] = [(leaf.q.data_ptr(), leaf.q.data_ptr() + leaf.q.numel()) for leaf in llm_params["layers"].values()
                   if isinstance(leaf, QuantWeight)]
        common.quantized_linear, _build.count_launch = lm_linear, lm_count
        manager.start()
        try:
            check(server.started.wait(60), "server started")
            url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"
            torch.cuda.synchronize()
            for fn in counters.values():  # count the measured turns only (not the build's warm-up)
                fn.launches = 0
            lm_launches[0] = 0
            encodes.update(whisper=0, smart_turn=0)
            predictions.clear()
            lines.records.clear()
            text = asyncio.run(_session(url, _text_turn(TEXT), _response_done, 600))
            audio, attempts = _voice_turns(url, "whisper serve", need_words=True)
            torch.cuda.synchronize()
            launches = {name: fn.launches for name, fn in counters.items()}
            launches["int8_matmul_lm"] = lm_launches[0]
            seen = dict(encodes)
        finally:
            stop.set()
            manager.stop()
            GLOBAL_MODEL_CACHE.clear()
    finally:
        whisper.encode = real_encode
        smart_turn.SmartTurnAnalyzer.predict = real_predict
        registry._load_checkpoint = real_load
        common.quantized_linear, _build.count_launch = real_linear, real_count
        for lg, level in zip(loggers, levels):
            lg.removeHandler(lines)
            lg.setLevel(level)
    try:
        steps = check_served_weights(files, llm_params, whisper_params)
    finally:
        del llm_params, whisper_params
        shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    check(launches["int8_matmul_lm"] > 0, f"the int8 kernel carried the checkpoint's LM in the whisper serve: {launches}")
    phase("checkpoint", card=card, files={f: {k: v for k, v in d.items() if k not in ("src", "out")}
                                          for f, d in files.items()},
          load_s=load_s, dequant_max_steps=steps)

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
    phase("whisper_serve", card=card, flags=flags[flags.index("--stt"):], build_s=build_s,
          ttfa_s=_first_audio_s(text), text_turn_s=text_done, audio_seconds=text_pcm.size / 24_000,
          voice_attempts=attempts, voice_turn=voice, whisper_final_infer_s=finals,
          smart_turn_predictions=len(predictions),
          smart_turn_inference_ms=[p.inference_ms for p in predictions],
          smart_turn_probability=[p.probability for p in predictions], encodes=seen, launches=launches)
    return launches


def head_logits_phase(dev: torch.device, card: list[str]) -> dict:
    """The heads' f32 logits with no copy of their weight a call: one greedy
    step of distil-large-v3 (random weights; its encoder output stands in as
    noise of its shape) after the first step, which keeps the f32 weight,
    must allocate less than half the f32 embedding; and the device time of
    the Whisper, talker codec and code-predictor heads as the product with
    the kept f32 weight, as the per-call cast it replaced, and as a bf16
    product with f32 output (``torch.mm(..., out_dtype=torch.float32)``,
    null where this PyTorch refuses it)."""
    from s2s_tpu_torch.models import qwen3_tts, whisper
    from s2s_tpu_torch.models.common import f32_weight

    cfg = whisper.WhisperConfig.distil_large_v3()
    params = whisper.init_params(cfg, torch.Generator(device=dev).manual_seed(31), dev)
    encoded = torch.randn((1, cfg.n_audio_ctx, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(32),
                          device=dev).to(cfg.dtype)
    state = whisper.init_decode_state(params, cfg, encoded)
    token = torch.full((1,), whisper.SOT, dtype=torch.int32, device=dev)
    logits, state = whisper.decode_step(params, cfg, token, state)  # keeps the f32 embedding
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    logits, state = whisper.decode_step(params, cfg, torch.argmax(logits, -1).to(torch.int32), state)
    torch.cuda.synchronize()
    step_bytes = torch.cuda.max_memory_allocated(dev) - base
    emb_f32_bytes = params["tok_emb"].numel() * 4
    check(step_bytes < emb_f32_bytes // 2,
          f"a Whisper decode step allocated {step_bytes} bytes (the f32 embedding is {emb_f32_bytes})")

    tts = qwen3_tts.Qwen3TTSConfig.qwen3_tts_12hz_1_7b()
    gen = torch.Generator(device=dev).manual_seed(33)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    # (tree, key, stored (out, in), input width): Whisper's tied embedding, the talker's codec head, one of the
    # code predictor's heads
    heads = {"whisper": (params, "tok_emb", True, cfg.d_model),
             "codec_head": ({"codec_head": bf16(tts.lm.d_model, tts.codec_vocab)}, "codec_head", False,
                            tts.lm.d_model),
             "cp_head": ({"cp_head": bf16(tts.cp.d_model, tts.codebook_size)}, "cp_head", False, tts.cp.d_model)}
    rows = {}
    for name, (tree, key, transposed, width) in heads.items():
        w = tree[key].T if transposed else tree[key]
        w32 = f32_weight(tree, key).T if transposed else f32_weight(tree, key)
        x = bf16(1, width)
        kept = x.float() @ w32
        check(torch.equal(kept, x.float() @ w.float()), f"{name}: the kept f32 weight gives the per-call cast's bits")
        row = {"kept_f32_ms": device_ms(lambda i: x.float() @ w32, 20),
               "per_call_cast_ms": device_ms(lambda i: x.float() @ w.float(), 20)}
        try:
            out = torch.mm(x, w, out_dtype=torch.float32)
            row["bf16_f32_out_ms"] = device_ms(lambda i: torch.mm(x, w, out_dtype=torch.float32), 20)
            row["bf16_f32_out_max_abs_err"] = (out - kept).abs().max().item()
        except (RuntimeError, TypeError) as exc:
            row["bf16_f32_out_ms"] = None
            row["bf16_f32_out_error"] = str(exc)[:120]
        row["weight"] = list(w.shape)
        rows[name] = row
    del params, state, encoded
    phase("head_logits", card=card, whisper_step_bytes=step_bytes, whisper_embedding_f32_bytes=emb_f32_bytes,
          heads=rows)
    return rows


def _silero_chunks(rng: np.random.Generator, tick: int, slots, n: int) -> np.ndarray:
    """One tick's (n, CHUNK) input: each active slot's row noise, a tone or
    silence by (tick + slot) % 3; inactive rows zero."""
    from s2s_tpu_torch.models.silero_vad import CHUNK, SR

    x = np.zeros((n, CHUNK), np.float32)
    t = (tick * CHUNK + np.arange(CHUNK)) / SR
    for s in slots:
        kind = (tick + s) % 3
        if kind == 0:
            x[s] = rng.standard_normal(CHUNK) * 0.1
        elif kind == 1:
            x[s] = 0.3 * np.sin(2 * np.pi * (180 + 20 * s) * t)
    return x


def silero_phase(dev: torch.device, card: list[str]) -> dict:
    """``BatchedSileroVAD(max_slots=16)`` on the card (random weights from
    seed 0, under torch's defaults, as the serve runs it) against the plain
    masked step on the CPU with the same parameters over ``SILERO_TICKS``
    ticks; slot isolation and ``reset_slot``; the single-session
    ``SileroVAD`` on the card against the CPU; then one tick's device time
    (CUDA graph of the masked step), its wall time with the host round trip
    (``_run_batch``: pack, copy in, step, copy the probabilities out), and
    its kernels and copies from ``torch.profiler``, at 1 and 16 active slots."""
    from torch.profiler import ProfilerActivity, profile

    from s2s_tpu_torch.models import silero_vad
    from s2s_tpu_torch.runtime.batcher import BatchedSileroVAD
    from s2s_tpu_torch.weights import tree_to_torch

    n = SILERO_SLOTS
    service = BatchedSileroVAD(max_slots=n, device=dev)
    params = tree_to_torch(service.params, "cpu")
    state = silero_vad.SileroState.create(n)
    rng = np.random.default_rng(23)
    prob_err, widths = 0.0, []
    for tick in range(SILERO_TICKS):
        width = (1, 4, 16)[min(tick // 16, 2)]
        slots = sorted(int(s) for s in rng.choice(n, width, replace=False))
        widths.append(width)
        x = _silero_chunks(rng, tick, slots, n)
        probs = service._run_batch(slots, [x[s] for s in slots])
        plain, new = silero_vad.step(params, state, torch.from_numpy(x))
        active = torch.zeros((n, 1), dtype=torch.bool)
        active[slots] = True
        state = silero_vad.SileroState(*(torch.where(active, a, b) for a, b in zip(new, state)))
        prob_err = max(prob_err, max(abs(p - plain[s].item()) for p, s in zip(probs, slots)))
        check(all(0.0 <= p <= 1.0 for p in probs), f"silero tick {tick}: probabilities in [0, 1]: {probs}")
    carry_err = max((a.cpu() - b).abs().max().item() for a, b in zip(service._state, state))
    check(prob_err <= SILERO_ATOL and carry_err <= SILERO_ATOL,
          f"batched Silero on the card vs the plain step on the CPU: |dprob| {prob_err}, |dcarry| {carry_err} "
          f"(bound {SILERO_ATOL})")

    before = [t.clone() for t in service._state]
    service._run_batch([0], [rng.standard_normal(silero_vad.CHUNK).astype(np.float32) * 0.1])
    isolated = all(torch.equal(a[1:], b[1:]) for a, b in zip(before, service._state))
    check(isolated, "a tick of slot 0 left every other slot's carry bitwise unchanged")
    before = [t.clone() for t in service._state]
    service.reset_slot(5)
    reset = all(torch.equal(t[5], torch.zeros_like(t[5])) and torch.equal(torch.cat([t[:5], t[6:]]),
                                                                           torch.cat([b[:5], b[6:]]))
                for t, b in zip(service._state, before))
    check(reset, "reset_slot(5) zeroed row 5 and left the others unchanged")

    single = silero_vad.SileroVAD(params=service.params, device=dev)
    plain_state, single_err = silero_vad.SileroState.create(1), 0.0
    for tick in range(8):
        x = _silero_chunks(rng, tick, [0], 1)
        plain, plain_state = silero_vad.step(params, plain_state, torch.from_numpy(x))
        single_err = max(single_err, abs(single(x[0]) - plain[0].item()))
    check(single_err <= SILERO_ATOL, f"single-session Silero on the card vs the CPU |dprob| {single_err}")

    timing = {}
    for width in (1, n):
        timer = BatchedSileroVAD(max_slots=n, params=service.params, device=dev)
        slots = list(range(width))
        x = _silero_chunks(rng, 0, slots, n)
        arrays = [x[s] for s in slots]
        packed = np.zeros((n, silero_vad.CHUNK + 1), np.float32)
        packed[slots, : silero_vad.CHUNK] = x[slots]
        packed[slots, silero_vad.CHUNK] = 1.0
        packed_dev = torch.from_numpy(packed).to(dev)
        device_tick = device_ms(lambda i: timer.masked_step(packed_dev), 20)
        for _ in range(10):
            timer._run_batch(slots, arrays)
        t0 = time.perf_counter()
        for _ in range(100):
            timer._run_batch(slots, arrays)
        wall = (time.perf_counter() - t0) / 100
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            timer._run_batch(slots, arrays)
            torch.cuda.synchronize()
        device = [e.name() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
        copies = sum(1 for name in device if name.startswith(("Memcpy", "Memset")))
        timing[width] = {"device_ms": device_tick, "wall_ms": wall * 1e3, "kernels": len(device) - copies,
                         "copies": copies}
        timer.close()
    service.close()
    result = {"slots": n, "ticks": SILERO_TICKS, "active_widths": sorted(set(widths)), "max_abs_prob_err": prob_err,
              "carry_max_abs_err": carry_err, "bound": SILERO_ATOL, "slot_isolation": isolated, "reset_slot": reset,
              "single_session_max_abs_err": single_err, "tick": timing}
    phase("silero", card=card, **result)
    return result


def resample_phase(dev: torch.device) -> dict:
    """``torch_resample_poly`` on the card against scipy and against the same
    function on the CPU (its plain version), 1 s of noise and a tone at each
    of ``RESAMPLE_RATES``, with the device time of a call."""
    import scipy.signal

    from s2s_tpu_torch.audio.resample import torch_resample_poly

    rng = np.random.default_rng(27)
    rows = []
    for from_rate, to_rate in RESAMPLE_RATES:
        t = np.arange(from_rate) / from_rate
        x = (0.2 * rng.standard_normal(from_rate) + 0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        x_dev = torch.from_numpy(x).to(dev)
        out = torch_resample_poly(x_dev, from_rate, to_rate)
        g = math.gcd(from_rate, to_rate)
        ref = scipy.signal.resample_poly(x, to_rate // g, from_rate // g)
        plain = torch_resample_poly(torch.from_numpy(x), from_rate, to_rate).numpy()
        got = out.cpu().numpy()
        check(got.shape == ref.shape, f"resample {from_rate}->{to_rate}: shape {got.shape} vs scipy {ref.shape}")
        err_scipy, err_plain = float(np.abs(got - ref).max()), float(np.abs(got - plain).max())
        check(err_scipy <= RESAMPLE_ATOL and err_plain <= RESAMPLE_ATOL,
              f"resample {from_rate}->{to_rate}: |d| vs scipy {err_scipy}, vs the CPU {err_plain}")
        rows.append({"from": from_rate, "to": to_rate, "samples_out": int(got.shape[0]),
                     "max_abs_err_scipy": err_scipy, "max_abs_err_plain": err_plain, "bound": RESAMPLE_ATOL,
                     "ms": device_ms(lambda i: torch_resample_poly(x_dev, from_rate, to_rate), 10)})
    phase("resample", rows=rows)
    return {"rows": rows}


def _voice_pcm(freq: float = 220.0, silence_s: float = 1.0) -> np.ndarray:
    """The voice turn's audio as PCM16 at 16 kHz: 0.25 s of silence, 2 s of a
    modulated tone, *silence_s* of silence."""
    rate = 16_000
    t = np.arange(2 * rate) / rate
    speech = 0.3 * np.sin(2 * np.pi * freq * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    pcm = np.concatenate([np.zeros(rate // 4), speech, np.zeros(int(silence_s * rate))])
    return (np.clip(pcm, -1, 1) * 32767).astype(np.int16)


def talk_phase(url: str, pool) -> dict:
    """The headless client (``s2s_tpu_torch.client.run_realtime_audio_client``,
    as ``s2s-tpu-torch talk --input_wav ... --output_wav ...`` runs it)
    against a running serve, once its pipeline units (*pool*) are free: the
    voice turn's audio in at real time, the reply's PCM out, which must not
    be silence."""
    import tempfile
    import wave
    from pathlib import Path
    from types import SimpleNamespace

    from s2s_tpu_torch import client

    with tempfile.TemporaryDirectory() as tmp:
        in_wav, out_wav = Path(tmp) / "in.wav", Path(tmp) / "out.wav"
        with wave.open(str(in_wav), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16_000)
            w.writeframes(_voice_pcm().tobytes())
        deadline = time.perf_counter() + 60  # the client takes no retry: wait until the last session is released
        while any(unit.session is not None for unit in pool) and time.perf_counter() < deadline:
            time.sleep(0.25)
        t0 = time.perf_counter()
        client.run_realtime_audio_client(SimpleNamespace(url=url, input_wav=str(in_wav), output_wav=str(out_wav),
                                                         instructions=None, voice=None, sample_rate=16_000))
        seconds = time.perf_counter() - t0
        check(out_wav.exists(), "talk: the client wrote the reply's audio")
        with wave.open(str(out_wav)) as w:
            rate, pcm = w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), np.int16)
    check(pcm.size > 0 and np.abs(pcm.astype(np.int32)).max() > 0, "talk: the reply's audio is not silence")
    result = {"seconds": seconds, "reply_audio_seconds": pcm.size / rate,
              "peak": int(np.abs(pcm.astype(np.int32)).max())}
    phase("talk", **result)
    return result


def deployment_config(tmp: str) -> str:
    """``DEPLOYMENT_CONFIG`` as served here: its ``checkpoint`` and
    ``tokenizer`` keys left out, its server on 127.0.0.1 port 0; written to
    *tmp*, returns the path."""
    from pathlib import Path

    config = json.loads((Path(__file__).resolve().parent / DEPLOYMENT_CONFIG).read_text())
    for section in ("stt", "llm", "tts"):
        config[section] = {k: v for k, v in config[section].items() if k not in ("checkpoint", "tokenizer")}
    config["server"] = {"host": "127.0.0.1", "port": 0}
    path = Path(tmp) / "config.json"
    path.write_text(json.dumps(config))
    return str(path)


def deployment_serve_phase(dev: torch.device, card: list[str]) -> dict[str, int]:
    """The repo's deployment config through its JSON form on the card, after
    the earlier serves shut down: build, two text turns (audio deltas and
    ``response.done``), then ``DEPLOYMENT_AUDIO_S`` of audio streamed into a
    session; Silero must tick once per 512 samples received with every
    probability in [0, 1], and no error event may come.  ``speech_started``
    is printed (0 with random Silero weights; not a pass condition).  Counts
    the int8 and decode-attention kernels' launches from the first text turn
    to the end, each > 0; returns them."""
    import tempfile

    from s2s_tpu_torch import cli
    from s2s_tpu_torch.models import silero_vad
    from s2s_tpu_torch.ops import decode_attention as da
    from s2s_tpu_torch.ops import int8_matmul as mm
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    ticks: list[float] = []
    real_call = silero_vad.SileroVAD.__call__

    def counted_call(self, chunk, sr=silero_vad.SR):
        prob = real_call(self, chunk, sr)
        ticks.append(prob)
        return prob

    tone_s, silence_s = DEPLOYMENT_AUDIO_S
    rate = 16_000
    t = np.arange(int(tone_s * rate)) / rate
    pcm = np.concatenate([0.3 * np.sin(2 * np.pi * 220 * t), np.zeros(int(silence_s * rate))])
    pcm16 = (pcm * 32767).astype(np.int16).tobytes()
    step = rate // 10 * 2  # 100 ms a append
    appends = [(0.0, {"type": "input_audio_buffer.append", "audio": base64.b64encode(pcm16[i : i + step]).decode()})
               for i in range(0, len(pcm16), step)]
    want_ticks = len(pcm16) // 2 // silero_vad.CHUNK

    torch.cuda.empty_cache()
    silero_vad.SileroVAD.__call__ = counted_call
    stop = threading.Event()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            manager, server, args = cli.build_from_argv(["--device", "cuda", deployment_config(tmp)], stop)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        check(args.vad.backend == "silero" and args.vad.smart_turn, "the deployment config: Silero and Smart Turn")
        manager.start()
        try:
            check(server.started.wait(60), "server started")
            url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"
            mm.int8_matmul.launches = da.concat_attention.launches = 0
            texts = [asyncio.run(_session(url, _text_turn(f"{TEXT} Turn {i}.", DEPLOYMENT_REPLY), _response_done, 600))
                     for i in range(2)]
            ticks.clear()

            def all_ticked(events, now):
                return len(ticks) >= want_ticks and now > tone_s + silence_s + 1.0

            audio = asyncio.run(_session(url, appends, all_ticked, 120))
            time.sleep(1.0)  # any tick past the count would show here
            torch.cuda.synchronize()
            launches = {"int8_matmul": mm.int8_matmul.launches, "decode_attention": da.concat_attention.launches}
            probs = list(ticks)
        finally:
            stop.set()
            manager.stop()
            GLOBAL_MODEL_CACHE.clear()
    finally:
        silero_vad.SileroVAD.__call__ = real_call

    turns = []
    for i, events in enumerate(texts):
        reply, done = _reply(events, f"deployment text turn {i}")
        turns.append({"ttfa_s": _first_audio_s(events), "turn_s": done, "audio_seconds": reply.size / 24_000})
    errors = [e for events in (*texts, audio) for _, e in events if e["type"] == "error"]
    check(not errors, f"deployment serve: no error events ({errors[:3]})")
    check(len(probs) == want_ticks, f"Silero ticked {len(probs)} times for {want_ticks} chunks of 512 samples")
    check(all(0.0 <= p <= 1.0 for p in probs), "Silero's probabilities lie in [0, 1]")
    check(all(v > 0 for v in launches.values()), f"the int8 and decode-attention kernels launched: {launches}")
    phase("deployment_serve", card=card, config=DEPLOYMENT_CONFIG, response=DEPLOYMENT_REPLY, build_s=build_s,
          text_turns=turns,
          audio_samples=len(pcm16) // 2, silero_ticks=len(probs), silero_prob_min=min(probs),
          silero_prob_max=max(probs),
          speech_started=sum(1 for _, e in audio if e["type"] == "input_audio_buffer.speech_started"),
          launches=launches)
    return launches


def tts_flags(flags: list[str], tts: str) -> list[str]:
    """*flags* (every flag with a value) with ``--tts`` set to *tts* and each
    ``--tts_*`` flag that *tts*'s arguments lack dropped: the Kokoro and MMS
    serves are ``BATCHED_FLAGS`` less the qwen3 TTS's engine flags (Kokoro
    and VITS synthesize one utterance a call, as the JAX package does)."""
    from s2s_tpu_torch.arguments import TTS_CONFIGS

    taken = {f"--tts_{f.name}" for f in dataclasses.fields(TTS_CONFIGS[tts])}
    out, it = [], iter(_with(flags, tts=tts))
    for flag in it:
        value = next(it)
        if not flag.startswith("--tts_") or flag in taken:
            out += [flag, value]
    return out


def tiny_kokoro_parity_phase(dev: torch.device) -> None:
    """Tiny Kokoro on the card against the same code and weights on the CPU:
    phase A at a padded token bucket (durations equal, d and t_en within
    ``KOKORO_PHASE_A_ATOL``), then whole syntheses of two texts (equal
    lengths, the waveform within ``KOKORO_WAV_ATOL`` and a relative RMS
    under ``KOKORO_WAV_REL_RMS``)."""
    from s2s_tpu_torch.models import kokoro
    from s2s_tpu_torch.weights import tree_to_torch as to

    cfg = kokoro.KokoroConfig.test_tiny()
    cpu = kokoro.init_params(cfg, torch.Generator().manual_seed(6))
    # the last generator conv scaled so the random waveform has speech's scale
    # (|wav| < 1), as tests/test_torch_port_kokoro.py does
    cpu["decoder"]["generator"]["post_w"] *= 0.1
    rng = np.random.default_rng(6)
    lengths = [16, 9]
    tokens = np.zeros((2, 16), np.int64)
    for row, n in enumerate(lengths):
        tokens[row, :n] = rng.integers(1, cfg.n_token, n)
    ref_s = (rng.standard_normal((2, 2 * cfg.style_dim)) * 0.5).astype(np.float32)
    out, wavs = {}, {}
    for label, device, params in (("cpu", "cpu", cpu), ("cuda", dev, to(cpu, dev))):
        dur, d, t_en = kokoro.encode_text(params, cfg, torch.from_numpy(tokens).to(device), torch.tensor(lengths),
                                          torch.from_numpy(ref_s).to(device), 1.0)
        out[label] = (dur.cpu(), d.cpu(), t_en.cpu())
        tts = kokoro.KokoroTTS(params=params, cfg=cfg, device=device)
        wavs[label] = [tts.synthesize(text, voice_id=v) for text, v in (("Hello there.", 0), (TEXT, 5))]
    check(torch.equal(out["cpu"][0], out["cuda"][0]), f"kokoro durations cuda vs cpu {out}")
    phase_a_err = max((a - b).abs().max().item() for a, b in zip(out["cpu"][1:], out["cuda"][1:]))
    check(phase_a_err <= KOKORO_PHASE_A_ATOL, f"kokoro d, t_en cuda vs cpu {phase_a_err}")
    wav_err, rel_rms = 0.0, 0.0
    for ref, got in zip(wavs["cpu"], wavs["cuda"]):
        check(ref.shape == got.shape and ref.size > 0, f"kokoro waveform lengths {ref.shape} vs {got.shape}")
        wav_err = max(wav_err, float(np.abs(ref - got).max()))
        rel_rms = max(rel_rms, float(np.sqrt(np.mean((ref - got) ** 2)) / np.sqrt(np.mean(ref ** 2))))
    check(wav_err <= KOKORO_WAV_ATOL and rel_rms < KOKORO_WAV_REL_RMS,
          f"kokoro waveform cuda vs cpu: max |d| {wav_err}, relative RMS {rel_rms}")
    phase("tiny_kokoro_parity", pred_dur=out["cpu"][0][0].tolist(), phase_a_max_abs_err=phase_a_err,
          samples=[w.size for w in wavs["cpu"]], wav_max_abs_err=wav_err, wav_rel_rms=rel_rms,
          bounds={"phase_a": KOKORO_PHASE_A_ATOL, "wav_atol": KOKORO_WAV_ATOL, "wav_rel_rms": KOKORO_WAV_REL_RMS})


def vits_flow_weights(tree, rng: np.random.RandomState, scale: float = 0.1) -> None:
    """Draw from *rng*, in place, the weights VITS initializes to zero: every
    coupling's ``post_w``/``post_b`` and every duration flow's
    ``proj_w``/``proj_b`` (the same paths in either package's tree, numpy or
    torch).  At zero the couplings' means and the spline parameters are
    constant, so the flows' WN and DDS stacks never reach the waveform."""
    layers = [(c, ("post_w", "post_b")) for c in tree["flow"]]
    layers += [(c, ("proj_w", "proj_b")) for c in tree["dp"]["conv_flows"]]
    for layer, names in layers:
        for name in names:
            w = (rng.standard_normal(tuple(layer[name].shape)) * scale).astype(np.float32)
            layer[name] = w if isinstance(layer[name], np.ndarray) else torch.from_numpy(w).to(layer[name].device)


def tiny_vits_parity_phase(dev: torch.device) -> None:
    """Tiny MMS/VITS on the card against the same code and weights on the
    CPU (its zero-initialized flow projections drawn by
    ``vits_flow_weights``): two lengths in one bucket, deterministic and
    with the noise drawn as the JAX wrapper draws it; ``n_samples`` equal,
    the waveform within ``VITS_WAV_ATOL``, exact zeros past each row's
    length on the card."""
    from s2s_tpu_torch.models import vits
    from s2s_tpu_torch.weights import tree_to_torch as to

    cfg = vits.VitsConfig.test_tiny()
    cpu = vits.init_params(cfg, torch.Generator().manual_seed(7))
    rng = np.random.RandomState(7)
    vits_flow_weights(cpu, rng)
    lengths = [24, 9]
    tokens = np.zeros((2, cfg.max_tokens), np.int64)
    for row, n in enumerate(lengths):
        tokens[row, :n] = rng.randint(1, cfg.vocab_size, n)
    noise = (rng.randn(2, cfg.max_tokens, 2).astype(np.float32) * 0.8,
             rng.randn(2, cfg.max_frames, cfg.flow_size).astype(np.float32) * 0.667)
    err, peak, zeros, samples = 0.0, 0.0, True, []
    for noisy in (False, True):
        out = {}
        for label, device, params in (("cpu", "cpu", cpu), ("cuda", dev, to(cpu, dev))):
            extra = [torch.from_numpy(n).to(device) for n in noise] if noisy else []
            wav, n = vits.synthesize(params, cfg, torch.from_numpy(tokens).to(device), torch.tensor(lengths), 1.0,
                                     *extra)
            out[label] = (wav.cpu(), n.cpu())
        check(torch.equal(out["cpu"][1], out["cuda"][1]), f"vits n_samples cuda vs cpu {out['cpu'][1]} "
              f"{out['cuda'][1]}")
        err = max(err, (out["cpu"][0] - out["cuda"][0]).abs().max().item())
        peak = max(peak, out["cpu"][0].abs().max().item())
        zeros = zeros and all(not out["cuda"][0][r, int(n):].any() for r, n in enumerate(out["cuda"][1]))
        samples.append(out["cpu"][1].tolist())
    check(err <= VITS_WAV_ATOL and zeros, f"vits waveform cuda vs cpu max |d| {err}, zeros past each length {zeros}")
    phase("tiny_vits_parity", n_samples=samples, wav_max_abs_err=err, bound=VITS_WAV_ATOL,
          zeros_past_each_length=zeros, wav_max_abs=peak)


def _fixture(path: str) -> tuple[dict, dict]:
    """A converted fixture file: (its ``tree`` as the registry loads a
    converted checkpoint, its ``fx`` arrays as numpy)."""
    from s2s_tpu_torch.registry import _load_checkpoint

    loaded = _load_checkpoint(path)
    return loaded["tree"], {k: np.asarray(v) for k, v in loaded["fx"].items()}


def _rel_err(ref: list[np.ndarray], got: list[np.ndarray]) -> float | None:
    """max |got - ref| over max |ref| across paired arrays; None where the
    shapes differ."""
    if [a.shape for a in ref] != [b.shape for b in got]:
        return None
    err = max(float(np.abs(a - b).max()) for a, b in zip(ref, got))
    peak = max(float(np.abs(a).max()) for a in ref)
    return err / peak if peak else err


def tiny_pocket_parity_phase(dev: torch.device) -> None:
    """Tiny Pocket-TTS on the card against the same code on the CPU, with
    the twin's converted weights (``POCKET_FIXTURE``): 12 frames' greedy
    codes equal to the fixture's, without and with its voice prefix, on both
    devices; the fixture's Mimi codes decoded within ``MIMI_WAV_ATOL`` of the
    CPU; then random weights (a torch seed): 24 frames' codes and EOS flags
    equal, and ``PocketTTS.stream`` of ``TEXT`` in the same chunks within
    ``TTS_WAV_REL`` x max|CPU|.  The card run is repeated with TF32 on, as a
    reading (not a gate)."""
    from s2s_tpu_torch import weights
    from s2s_tpu_torch.models import mimi, pocket_tts

    tree, fx = _fixture(POCKET_FIXTURE)
    cfg = pocket_tts.PocketTTSConfig.tiny()
    drawn = pocket_tts.init_params(cfg, torch.Generator().manual_seed(8))

    def run(device) -> dict:
        p = weights.pocket_params(tree, device)
        out = {}
        for voice in (None, fx["voice"]):
            state = pocket_tts.init_state(cfg, 1, cache_len=64, device=device)
            if voice is not None:
                state = state._replace(lm_state=pocket_tts.prefill_voice(
                    p, cfg, torch.from_numpy(voice).to(device), state.lm_state))
            codes, _, _ = pocket_tts.generate_frames(p, cfg, torch.from_numpy(fx["text"]).to(device), state, 12)
            out["codes" if voice is None else "codes_v"] = codes.cpu().numpy()
        out["wav"] = mimi.decode(p["mimi"], cfg.mimi, torch.from_numpy(fx["mimi_codes"]).to(device)).cpu().numpy()
        model = pocket_tts.PocketTTS(params=weights.tree_to_torch(drawn, device), cfg=cfg, device=device)
        state = pocket_tts.init_state(cfg, 1, cache_len=64, device=device)
        codes, eos, _ = pocket_tts.generate_frames(model.params, cfg, model._text_array(TEXT), state, 24)
        out["drawn"] = (codes.cpu().numpy(), eos.cpu().numpy())
        out["stream"] = [a for a, _ in model.stream(TEXT)]
        return out

    cpu = run("cpu")
    for key in ("codes", "codes_v"):
        check(np.array_equal(cpu[key], fx[key]), f"tiny pocket {key} on the CPU equal the fixture's")
    readings = {}
    for label, enabled in (("tf32_off", False), ("tf32_on", True)):
        with tf32_mode(enabled):
            card = run(dev)
        readings[label] = {
            "fixture_codes_equal": all(np.array_equal(card[k], fx[k]) for k in ("codes", "codes_v")),
            "drawn_codes_equal": all(np.array_equal(a, b) for a, b in zip(card["drawn"], cpu["drawn"])),
            "mimi_wav_max_abs_err": float(np.abs(card["wav"] - cpu["wav"]).max()),
            "stream_chunks": [a.size for a in card["stream"]],
            "stream_max_abs_err_rel": _rel_err(cpu["stream"], card["stream"]),
        }
    off = readings["tf32_off"]
    check(off["fixture_codes_equal"] and off["drawn_codes_equal"], f"tiny pocket codes cuda vs cpu {off}")
    check(off["mimi_wav_max_abs_err"] <= MIMI_WAV_ATOL, f"tiny mimi waveform cuda vs cpu {off}")
    check(off["stream_max_abs_err_rel"] is not None and off["stream_max_abs_err_rel"] <= TTS_WAV_REL,
          f"tiny pocket stream cuda vs cpu {off}")
    phase("tiny_pocket_parity", fixture_frames=12, voice_rows=int(fx["voice"].shape[1]),
          mimi_wav_cpu_vs_fixture=float(np.abs(cpu["wav"] - fx["mimi_wav"]).max()),
          stream_chunks_cpu=[a.size for a in cpu["stream"]], readings=readings,
          bounds={"mimi_wav_atol": MIMI_WAV_ATOL, "stream_rel": TTS_WAV_REL})


def tiny_chattts_parity_phase(dev: torch.device) -> None:
    """Tiny ChatTTS on the card against the same code on the CPU, with the
    twin's converted weights (``CHATTTS_FIXTURE``): 10 frames' greedy codes
    equal to the fixture's, with and without its speaker, on both devices;
    the DVAE's mel of the fixture's codes within ``CHATTTS_MEL_ATOL`` of the
    CPU; then random weights (a torch seed, the Vocos head scaled by 50 as
    ``tests/test_chattts.py`` scales it) and an explicit speaker:
    ``ChatTTSModel.synthesize`` of two texts, the same lengths and within
    ``TTS_WAV_REL`` x max|CPU|.  The card run is repeated with TF32 on, as a
    reading (not a gate)."""
    from s2s_tpu_torch import weights
    from s2s_tpu_torch.models import chattts, decoder_lm

    tree, fx = _fixture(CHATTTS_FIXTURE)
    cfg = chattts.ChatTTSConfig.tiny()
    drawn = chattts.init_params(cfg, torch.Generator().manual_seed(9))
    drawn["vocos"]["head"]["w"] *= 50.0
    speaker = chattts.sample_speaker(drawn, torch.Generator().manual_seed(9))
    texts = ("Hello there.", TEXT)

    def run(device) -> dict:
        p = weights.chattts_params(tree, device)
        out = {}
        for key, spk in (("codes", fx["spk"]), ("codes_nospk", None)):
            state = decoder_lm.init_decode_state(cfg.gpt, 1, max_t=64, device=device)
            cstate, codes0, _ = chattts.prefill(p, cfg, torch.from_numpy(fx["text"]).to(device),
                                                None if spk is None else torch.from_numpy(spk).to(device), state)
            rest, _, _ = chattts.generate_codes(p, cfg, cstate, 9)
            out[key] = torch.cat([codes0[None], rest]).cpu().numpy()
        out["mel"] = chattts.dvae_decode(p["dvae"], cfg.dvae,
                                         torch.from_numpy(fx["codes"]).to(device).transpose(0, 1)).cpu().numpy()
        model = chattts.ChatTTSModel(params=weights.tree_to_torch(drawn, device), cfg=cfg, device=device)
        out["wavs"] = [model.synthesize(text, speaker=speaker) for text in texts]
        return out

    cpu = run("cpu")
    for key in ("codes", "codes_nospk"):
        check(np.array_equal(cpu[key], fx[key]), f"tiny chattts {key} on the CPU equal the fixture's")
    readings = {}
    for label, enabled in (("tf32_off", False), ("tf32_on", True)):
        with tf32_mode(enabled):
            card = run(dev)
        readings[label] = {
            "fixture_codes_equal": all(np.array_equal(card[k], fx[k]) for k in ("codes", "codes_nospk")),
            "mel_max_abs_err": float(np.abs(card["mel"] - cpu["mel"]).max()),
            "samples": [a.size for a in card["wavs"]],
            "wav_max_abs_err_rel": _rel_err(cpu["wavs"], card["wavs"]),
        }
    off = readings["tf32_off"]
    check(off["fixture_codes_equal"] and off["mel_max_abs_err"] <= CHATTTS_MEL_ATOL,
          f"tiny chattts codes and mel cuda vs cpu {off}")
    check(off["wav_max_abs_err_rel"] is not None and off["wav_max_abs_err_rel"] <= TTS_WAV_REL,
          f"tiny chattts waveforms cuda vs cpu {off}")
    phase("tiny_chattts_parity", fixture_frames=10, mel_cpu_vs_fixture=float(np.abs(cpu["mel"] - fx["mel"]).max()),
          samples_cpu=[a.size for a in cpu["wavs"]], readings=readings,
          bounds={"mel_atol": CHATTTS_MEL_ATOL, "wav_rel": TTS_WAV_REL})


def _device_events(fn):
    """(result, device events) of ``fn()`` under ``torch.profiler`` (device
    activity only)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    return result, [e for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA]


def _busy_ms(device) -> float:
    """The union of the events' spans, in ms."""
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in device)
    busy_ns, end = 0, spans[0][0] if spans else 0
    for start, stop in spans:
        busy_ns += max(0, stop - max(start, end))
        end = max(end, stop)
    return busy_ns / 1e6


def _device_activity(fn):
    """(result, device busy ms, kernels, copies and memsets) of ``fn()``."""
    result, device = _device_events(fn)
    copies = sum(1 for e in device if e.name().startswith(("Memcpy", "Memset")))
    return result, _busy_ms(device), len(device) - copies, copies


def _synthesis_profile(model) -> list[dict]:
    """One synthesis of each of ``SYNTH_TEXTS`` on the served model, after a
    warm one: its wall time and peak allocation above what was resident
    (every served model), then, under ``torch.profiler``, the device busy
    time and kernels of each part (Kokoro: phase A, the alignment, phase B;
    MMS/VITS: its one program)."""
    from s2s_tpu_torch.models import kokoro, vits

    rows = []
    for bucket, text in SYNTH_TEXTS.items():
        model.synthesize(text)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model.synthesize(text)  # returns host audio: synchronized
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        parts = {}
        with torch.inference_mode():
            if isinstance(model, kokoro.KokoroTTS):
                cfg = model.cfg
                ids = model._encode(text)[: cfg.max_tokens] or [1]
                check(model.token_bucket(len(ids)) == bucket, f"{len(ids)} ids in token bucket {bucket}")
                tokens = torch.zeros((1, bucket), dtype=torch.long)
                tokens[0, : len(ids)] = torch.tensor(ids)
                ref_s = model._ref_s(0, len(ids))
                (dur, d, t_en), *parts["phase_a"] = _device_activity(lambda: kokoro.encode_text(
                    model.params, cfg, tokens.to(model.device), torch.tensor([len(ids)]), ref_s, 1.0))
                total = int(torch.sum(dur[0]))
                frames = model.frame_bucket(total)
                (en, asr), *parts["align"] = _device_activity(
                    lambda: (kokoro.align(d, dur, frames), kokoro.align(t_en, dur, frames)))
                audio, *parts["phase_b"] = _device_activity(lambda: kokoro.vocode(model.params, cfg, en, asr, ref_s))
                samples = min(total, frames) * cfg.samples_per_frame
                shape = {"tokens": len(ids), "token_bucket": bucket, "frames": total, "frame_bucket": frames}
            else:
                cfg = model.cfg
                ids = model._encode(text, model.tokenizer)[: cfg.max_tokens]
                tokens = torch.zeros((1, cfg.max_tokens), dtype=torch.long)
                tokens[0, : len(ids)] = torch.tensor(ids)
                (audio, n), *parts["program"] = _device_activity(lambda: vits.synthesize(
                    model.params, cfg, tokens.to(model.device), torch.tensor([len(ids)]), 1.0))
                samples = int(n[0])
                shape = {"tokens": len(ids), "token_bucket": cfg.max_tokens, "frame_bucket": cfg.max_frames}
        check(bool(torch.isfinite(audio).any()), "the synthesis wrote samples")
        audio = audio.reshape(-1)[:samples]
        finite = torch.isfinite(audio)
        rows.append({**shape, "audio_seconds": samples / cfg.sample_rate, "wall_ms": wall * 1e3,
                     "nonfinite_share": 1.0 - finite.float().mean().item(),
                     "max_abs_finite": audio[finite].abs().max().item() if finite.any() else None,
                     "parts": {k: {"device_ms": v[0], "kernels": v[1], "copies": v[2]} for k, v in parts.items()},
                     "kernels": sum(v[1] for v in parts.values()), "peak_bytes_above_resident": peak,
                     "resident_bytes": base})
    return rows


@contextlib.contextmanager
def _profiled(module, name: str, calls: list, traced: int | None = None):
    """The first *traced* calls (all by default) of ``module.name`` in the
    block run under ``_device_activity``; *calls* gets (device ms, kernels,
    copies, the call's positional arguments) for each, the device fields
    None for a call run untraced."""
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        if traced is not None and len(calls) >= traced:
            calls.append((None, None, None, args))
            return real(*args, **kwargs)
        result, busy, kernels, copies = _device_activity(lambda: real(*args, **kwargs))
        calls.append((busy, kernels, copies, args))
        return result

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def _part(calls: list) -> dict:
    """A part's traced calls summed (device time and kernels of its untraced
    calls are not measured)."""
    traced = [c for c in calls if c[0] is not None]
    return {"calls": len(calls), "traced_calls": len(traced), "device_ms": sum(c[0] for c in traced),
            "kernels": sum(c[1] for c in traced), "copies": sum(c[2] for c in traced)}


def _timed_synthesis(fn) -> tuple[np.ndarray, float, int, int]:
    """(audio, wall s, peak bytes above what was resident, resident bytes) of
    ``fn()``, on a model the serve's turns have already run (no warm call);
    *fn* returns host audio, so it has synchronized."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    audio = fn()
    wall = time.perf_counter() - t0
    return audio, wall, torch.cuda.max_memory_allocated() - base, base


def _pocket_profile(model) -> list[dict]:
    """One Pocket synthesis of each of ``PROFILED_TEXTS`` and one of ``TEXT``
    through a random voice prefix of ``POCKET_VOICE_ROWS`` rows (added with
    ``add_voice``) on the served model: wall time and peak allocation, then
    under ``torch.profiler`` the frame generation of the first
    ``POCKET_TRACED_CHUNKS`` 8-frame chunks and every chunk's Mimi re-decode
    (with ``decode_deficit`` frames of left context): device time, kernels,
    and the frames each decode covers."""
    from s2s_tpu_torch.models import mimi, pocket_tts

    voice = np.random.default_rng(0).normal(0, 0.3, (POCKET_VOICE_ROWS, model.cfg.backbone.d_model))
    model.add_voice("profiled", voice)
    rows = []
    for text, voice_name in [*((t, None) for t in PROFILED_TEXTS), (TEXT, "profiled")]:
        audio, wall, peak, base = _timed_synthesis(lambda: model.synthesize(text, voice=voice_name))
        frames, decodes = [], []
        t0 = time.perf_counter()
        with _profiled(pocket_tts, "generate_frames", frames, POCKET_TRACED_CHUNKS), \
                _profiled(mimi, "decode", decodes):
            profiled = model.synthesize(text, voice=voice_name)
        profiled_s = time.perf_counter() - t0
        check(profiled.size == audio.size, f"pocket profiled synthesis {profiled.size} samples vs {audio.size}")
        decoded = [c[3][2].shape[1] for c in decodes]
        parts = {"frames": _part(frames), "mimi_redecode": _part(decodes)}
        rows.append({"text_chars": len(text), "voice_rows": POCKET_VOICE_ROWS if voice_name else 0,
                     "frames": sum(c[3][4] for c in frames), "chunks": len(frames),
                     "audio_seconds": audio.size / pocket_tts.SAMPLE_RATE, "wall_ms": wall * 1e3,
                     "profiled_wall_ms": profiled_s * 1e3, "first_chunk_device_ms": frames[0][0] + decodes[0][0],
                     "max_abs": float(np.abs(audio).max()),
                     "parts": parts, "mimi_frames_per_decode": [min(decoded), max(decoded)],
                     "per_chunk_device_ms": {k: v["device_ms"] / v["traced_calls"] for k, v in parts.items()},
                     "kernels": sum(v["kernels"] for v in parts.values()),
                     "peak_bytes_above_resident": peak, "resident_bytes": base})
    return rows


def _chattts_profile(model) -> list[dict]:
    """One ChatTTS synthesis of each of ``PROFILED_TEXTS`` (speaker seed 0) on
    the served model: wall time and peak allocation, then under
    ``torch.profiler`` the prefill with the AR loop's first
    ``CHATTTS_TRACED_STEPS`` steps (the loop split there; the rest runs
    untraced), and the DVAE with Vocos and the iSTFT: device time and
    kernels."""
    from s2s_tpu_torch.models import chattts

    real_codes = chattts.generate_codes
    rows = []
    for text in PROFILED_TEXTS:
        audio, wall, peak, base = _timed_synthesis(lambda: model.synthesize(text, seed=0))
        pre, loop, vocoder = [], [], []

        def split_codes(params, cfg, state, n_tokens):  # chunked generation is exact, as one-shot
            k = min(n_tokens, CHATTTS_TRACED_STEPS)
            head, *traced = _device_activity(lambda: real_codes(params, cfg, state, k))
            loop.append((*traced, (params, cfg, state, k)))
            if k == n_tokens:
                return head
            tail = real_codes(params, cfg, head[2], n_tokens - k)
            loop.append((None, None, None, (params, cfg, head[2], n_tokens - k)))
            return torch.cat([head[0], tail[0]]), torch.cat([head[1], tail[1]]), tail[2]

        t0 = time.perf_counter()
        chattts.generate_codes = split_codes
        try:
            with _profiled(chattts, "prefill", pre), _profiled(chattts, "dvae_decode", vocoder), \
                    _profiled(chattts, "vocos_decode", vocoder):
                profiled = model.synthesize(text, seed=0)
        finally:
            chattts.generate_codes = real_codes
        profiled_s = time.perf_counter() - t0
        check(profiled.size == audio.size, f"chattts profiled synthesis {profiled.size} samples vs {audio.size}")
        parts = {"prefill_and_ar": _part(pre + loop), "dvae_vocos_istft": _part(vocoder)}
        rows.append({"text_chars": len(text), "prompt_tokens": int(model._encode(text).shape[1]),
                     # the prefill's frame, then the AR steps
                     "tokens": 1 + sum(c[3][3] for c in loop),
                     "ar_traced_steps": sum(c[3][3] for c in loop if c[0] is not None),
                     "audio_seconds": audio.size / chattts.SAMPLE_RATE,
                     "wall_ms": wall * 1e3, "profiled_wall_ms": profiled_s * 1e3,
                     "max_abs": float(np.abs(audio).max()) if audio.size else 0.0,
                     "parts": parts, "kernels": sum(v["kernels"] for v in parts.values()),
                     "peak_bytes_above_resident": peak, "resident_bytes": base})
    return rows


def _timed_method(cls, name: str, synths: list):
    """*cls*'s method *name* with each call's wall time and audio seconds
    appended to *synths*: ``synthesize`` returns host audio (so it has
    synchronized); ``stream`` is a generator, timed inside its own steps (not
    while the handler holds a chunk)."""
    real = getattr(cls, name)
    if name == "synthesize":
        def timed(self, *args, **kwargs):
            t = time.perf_counter()
            audio = real(self, *args, **kwargs)
            synths.append((time.perf_counter() - t, audio.size / self.cfg.sample_rate))
            return audio
        return timed

    def timed_stream(self, *args, **kwargs):
        spent, seconds = 0.0, 0.0
        steps = real(self, *args, **kwargs)
        try:
            while True:
                t = time.perf_counter()
                try:
                    audio, rate = next(steps)
                except StopIteration:
                    return
                finally:
                    spent += time.perf_counter() - t
                seconds += audio.size / rate
                yield audio, rate
        finally:
            synths.append((spent, seconds))
    return timed_stream


def _served_tts_class(tts: str):
    from s2s_tpu_torch.models import chattts, kokoro, pocket_tts, vits

    return {"kokoro": kokoro.KokoroTTS, "facebookMMS": vits.VitsTTS, "pocket": pocket_tts.PocketTTS,
            "chatTTS": chattts.ChatTTSModel}[tts]


def served_tts_model(tts: str, dev: torch.device):
    """Pocket's or ChatTTS's served model at ``POCKET_SERVE_LAYERS`` or
    ``CHATTTS_SERVE_LAYERS`` (full width, random weights from seed 0 as the
    registry draws them; Pocket's through ``audible_pocket``), for the model
    cache under the factory's key."""
    from s2s_tpu_torch.models import chattts, pocket_tts

    if tts == "pocket":
        cfg = pocket_tts.PocketTTSConfig()
        backbone, dep = POCKET_SERVE_LAYERS
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, n_layers=backbone),
                                  dep=dataclasses.replace(cfg.dep, n_layers=dep))
        return ("pocket-tts", None, None, str(dev)), lambda: audible_pocket(pocket_tts.PocketTTS(cfg=cfg, device=dev))
    cfg = chattts.ChatTTSConfig()
    cfg = dataclasses.replace(cfg, gpt=dataclasses.replace(cfg.gpt, n_layers=CHATTTS_SERVE_LAYERS))
    return ("chattts", None, str(dev)), lambda: chattts.ChatTTSModel(cfg=cfg, device=dev)


@contextlib.contextmanager
def served_depth(lm_layers: int | None, talker_layers: int | None, cp_layers: int | None):
    """SmolLM2-1.7B built with *lm_layers* layers and Qwen3-TTS 1.7B's
    talker and code predictor with *talker_layers* and *cp_layers* (None:
    whole) by the serves built in the block: ``--llm_model_size
    smollm2-1.7b``'s ``lm_config`` and ``--tts_model_size 1.7b``'s
    configuration, cut in depth, widths kept."""
    from s2s_tpu_torch.llm import local_backend
    from s2s_tpu_torch.models import qwen3_tts

    real_lm, real_tts = local_backend.lm_config, qwen3_tts.CONFIGS["1.7b"]

    def lm_config(model_size: str):
        cfg = real_lm(model_size)
        return dataclasses.replace(cfg, n_layers=lm_layers) if lm_layers and model_size == "smollm2-1.7b" else cfg

    def tts_config():
        cfg = real_tts()
        if talker_layers:
            cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, n_layers=talker_layers))
        return dataclasses.replace(cfg, cp=dataclasses.replace(cfg.cp, n_layers=cp_layers)) if cp_layers else cfg

    local_backend.lm_config, qwen3_tts.CONFIGS["1.7b"] = lm_config, tts_config
    try:
        yield
    finally:
        local_backend.lm_config, qwen3_tts.CONFIGS["1.7b"] = real_lm, real_tts


def audible_pocket(model):
    """*model* with its Mimi output conv scaled by ``POCKET_MIMI_OUT_SCALE``
    (random full-width Mimi output sits under the handler's silence
    threshold)."""
    model.params["mimi"]["final_conv"]["w"] *= POCKET_MIMI_OUT_SCALE
    return model


def tts_serve_phase(dev: torch.device, card: list[str], tts: str) -> dict[str, int]:
    """The 4-session batched cascade with ``--tts kokoro``, ``facebookMMS``,
    ``pocket`` or ``chatTTS`` (``tts_flags(BATCHED_FLAGS, tts)``; full
    width, random weights from seed 0, torch's defaults; Pocket's and
    ChatTTS's models at the depths of ``served_tts_model``, placed in the
    model cache under the factories' keys, Pocket's with ``audible_pocket``): build (the LM and Parakeet
    engines warmed), every count set to 0, four concurrent text turns (one a
    session), then voice turns in one session (``VOICE_TONES_HZ`` until one
    is answered); every reply must be non-silent PCM with ``response.done``,
    and the int8, decode-attention and Parakeet log-mel kernels must have
    launched in the turns.  Each served synthesis is timed
    (``_timed_method``), then syntheses of ``SYNTH_TEXTS`` are profiled on
    the served model (``_synthesis_profile``, ``_pocket_profile``,
    ``_chattts_profile``).  Returns the kernels' launches over the turns."""
    from s2s_tpu_torch import builder, cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    name, method = TTS_SERVES[tts]
    flags = tts_flags(BATCHED_FLAGS, tts)
    cls = _served_tts_class(tts)
    counters = _launch_counters()
    synths: list[tuple[float, float]] = []
    real_method, untimed = getattr(cls, method), builder.warmup_engines
    warm = {}

    def timed_warmup():
        torch.cuda.synchronize()
        t = time.perf_counter()
        untimed()
        warm["s"] = time.perf_counter() - t

    setattr(cls, method, _timed_method(cls, method, synths))
    builder.warmup_engines = timed_warmup
    stop = threading.Event()
    try:
        model_s = None
        if tts in ("pocket", "chatTTS"):
            t0 = time.perf_counter()
            GLOBAL_MODEL_CACHE.get(*served_tts_model(tts, dev))
            torch.cuda.synchronize()
            model_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            manager, server, _ = cli.build_from_argv(["--device", "cuda", *flags], stop)
        finally:
            builder.warmup_engines = untimed
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0 - warm.get("s", 0.0)
        manager.start()
        try:
            check(server.started.wait(60), "server started")
            url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"
            models = {id(h.model): h.model for h in manager.handlers if isinstance(getattr(h, "model", None), cls)}
            check(len(models) == 1, f"the {SESSIONS} units share one {cls.__name__}: {len(models)}")
            with counted_transcriptions() as stt:
                for fn in counters.values():  # count the measured turns only
                    fn.launches = 0
                synths.clear()
                t0 = time.perf_counter()
                rounds = asyncio.run(_concurrent_text_turns(url, SESSIONS))
                round_s = time.perf_counter() - t0
                text_synths = list(synths)
                audio, attempts = _voice_turns(url, f"{tts} serve", need_words=False)
                torch.cuda.synchronize()
                launches = {name: fn.launches for name, fn in counters.items()}
            served = synths[:]
            model = next(iter(models.values()))
            profile = {"pocket": _pocket_profile, "chatTTS": _chattts_profile}.get(tts, _synthesis_profile)
            t0 = time.perf_counter()
            profile_rows = profile(model)
            profile_s = time.perf_counter() - t0
        finally:
            stop.set()
            manager.stop()
            GLOBAL_MODEL_CACHE.clear()
    finally:
        setattr(cls, method, real_method)
        builder.warmup_engines = untimed

    check("s" in warm, "--warmup_engines warmed the batched engines")
    sessions = []
    for i, events in enumerate(rounds):
        pcm, done = _reply(events, f"{tts} concurrent text turn {i}")
        sessions.append({"ttfa_s": _first_audio_s(events), "turn_s": done, "audio_seconds": pcm.size / 24_000})
    check(audio is not None, f"{tts} serve: a voice turn answered with audio: {attempts}")
    voice = _voice_summary(audio)
    for kernel in ("int8_matmul", "decode_attention"):
        check(launches[kernel] > 0, f"{kernel} launched in the {tts} serve's turns: {launches}")
    check_parakeet_frontend(launches["parakeet_log_mel"], stt["batches"], f"{tts} serve")
    wall, seconds = sum(w for w, _ in served), sum(a for _, a in served)
    extra = {}
    if tts in ("pocket", "chatTTS"):
        extra = {"model_build_s": model_s,
                 "lm_layers": POCKET_SERVE_LAYERS if tts == "pocket" else CHATTTS_SERVE_LAYERS}
    if tts == "pocket":
        extra["mimi_out_scale"] = POCKET_MIMI_OUT_SCALE
    phase(name, card=card, flags=flags[flags.index("--tts"):][:2],
          sessions=SESSIONS, build_s=build_s, warmup_s=warm["s"], round_s=round_s, text_turns=sessions,
          voice_attempts=attempts, voice_turn=voice, transcription_batches=stt["batches"],
          syntheses=len(served), synthesis_audio_s=seconds, synthesis_wall_s=wall,
          synthesis_rtf=seconds / wall if wall else 0.0,
          text_round_synthesis_wall_s=[w for w, _ in text_synths],
          launches={k: launches[k] for k in ("int8_matmul", "decode_attention", "parakeet_log_mel")},
          per_synthesis=profile_rows, profile_s=profile_s,
          tf32={"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32}, **extra)
    return launches


def merged_logits(vision_params, lm_params, pixels_nchw: torch.Tensor, ids: torch.Tensor):
    """The SmolVLM fixture's merged forward on the port: the tiny tower's
    features spliced at the image-token span (id 127), then each prefix
    length's last hidden through ``prefill_embeds`` and the tied head.
    Returns (image features (1, 4, 64), logits (T, V))."""
    from s2s_tpu_torch.models import decoder_lm, vision

    cfg = decoder_lm.DecoderLMConfig(**SMOLVLM_LM, dtype=torch.float32)
    feats = vision.encode_image(vision_params, vision.VisionConfig.test_tiny(), pixels_nchw.permute(0, 2, 3, 1))
    embeds = lm_params["embed"][ids[0].long()][None].clone()
    embeds[0, ids[0] == 127] = feats[0]
    rows = []
    for k in range(1, ids.shape[1] + 1):
        state = decoder_lm.init_decode_state(cfg, 1, max_t=ids.shape[1], device=embeds.device)
        hidden, _ = decoder_lm.prefill_embeds(lm_params, cfg, embeds[:, :k], state, k)
        rows.append(hidden[0] @ lm_params["embed"].T)
    return feats, torch.stack(rows)


def image_url(side: int = IMAGE_SIDE, color: str = "red") -> str:
    """A ``data:`` URL of a PNG written here: a checkerboard of *color*
    ("red", "green" or "blue") over a gradient."""
    y, x = np.mgrid[:side, :side]
    rgb = np.stack([x * 255 // side, y * 255 // side, (x + y) * 127 // side], axis=-1).astype(np.uint8)
    rgb[(x // 12 + y // 12) % 2 == 1, ("red", "green", "blue").index(color)] = 230
    return "data:image/png;base64," + base64.b64encode(png_bytes(rgb)).decode()


def tiny_paraformer_parity_phase(dev: torch.device) -> None:
    """Tiny Paraformer on the card against the same code on the CPU: the
    FunASR twin's converted weights (``PARAFORMER_FIXTURE``) give the
    fixture's token count and ids on both, the encoder output within
    ``PARAFORMER_ENC_ATOL``; random weights (a torch seed) give equal ids
    and counts at three valid lengths in the padded bucket; LFR + CMVN
    bit-equal."""
    from s2s_tpu_torch import weights
    from s2s_tpu_torch.models import paraformer

    tree, fx = _fixture(PARAFORMER_FIXTURE)
    cfg = paraformer.ParaformerConfig.test_tiny()
    drawn = paraformer.init_params(cfg, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((1, cfg.max_frames, cfg.input_size)).astype(np.float32)
    fbank = rng.standard_normal((301, 80)).astype(np.float32)
    t = fx["feats"].shape[1]
    buf = np.zeros((1, cfg.max_frames, cfg.input_size), np.float32)
    buf[0, :t] = fx["feats"][0]

    def run(device) -> dict:
        p, q = weights.paraformer_params(tree, device), weights.tree_to_torch(drawn, device)
        out = {"enc": paraformer.encode(p, cfg, torch.from_numpy(fx["feats"]).to(device),
                                        torch.ones((1, t, 1), device=device)).cpu().numpy()}
        for name, params, x, lengths in (("fixture", p, buf, (t,)), ("drawn", q, feats, (7, 20, 32))):
            for n in lengths:
                ids, count = paraformer.forward(params, cfg, torch.from_numpy(x).to(device),
                                                torch.tensor([n], dtype=torch.int32, device=device))
                out[f"{name}_{n}"] = (ids.cpu().numpy(), int(count[0]))
        out["lfr"] = paraformer.lfr_cmvn(*(torch.from_numpy(a).to(device) for a in (
            fbank, fx["feats"][0, 0].repeat(20), np.ones(560, np.float32)))).cpu().numpy()
        return out

    cpu, card = run("cpu"), run(dev)
    n_ref = fx["acoustic"].shape[1]
    want = np.argmax(fx["logits"], -1)[0]
    for side, out in (("cpu", cpu), ("cuda", card)):
        ids, n = out[f"fixture_{t}"]
        check(n == n_ref and np.array_equal(ids[0, :n], want), f"tiny paraformer {side}: the fixture's {n_ref} ids")
    same = {k: bool(np.array_equal(cpu[k][0], card[k][0]) and cpu[k][1] == card[k][1])
            for k in cpu if k.startswith(("fixture", "drawn"))}
    enc_err = float(np.abs(cpu["enc"] - card["enc"]).max())
    check(all(same.values()), f"tiny paraformer ids and counts cuda vs cpu {same}")
    check(enc_err <= PARAFORMER_ENC_ATOL, f"tiny paraformer encoder cuda vs cpu {enc_err}")
    check(np.array_equal(cpu["lfr"], card["lfr"]), "LFR + CMVN cuda vs cpu bit-equal")
    phase("tiny_paraformer_parity", fixture_tokens=n_ref, counts={k: card[k][1] for k in same},
          enc_max_abs_err=enc_err, bound=PARAFORMER_ENC_ATOL)


def tiny_vlm_parity_phase(dev: torch.device) -> None:
    """The tiny SigLIP tower and the VLM stage on the card against the CPU:
    transformers' SmolVLM fixture through the JAX converters
    (``SMOLVLM_FIXTURE``): image features within ``VISION_ATOL`` of the CPU
    (and the JAX package's 2e-4 of transformers'), the merged forward's
    logits within ``VISION_ATOL`` of the CPU with its argmax; then the
    stage (``VisionLocalTorchLLMHandler`` at the tiny LM and tower, random
    weights from a torch seed) on a PNG data URL: the same greedy text on
    both devices."""
    import threading
    from queue import Queue

    from s2s_tpu_torch import weights
    from s2s_tpu_torch.llm.vlm_backend import VisionLocalTorchLLMHandler
    from s2s_tpu_torch.models import decoder_lm, vision
    from s2s_tpu_torch.registry import _load_checkpoint

    loaded = _load_checkpoint(SMOLVLM_FIXTURE)
    fx = {k: np.asarray(v) for k, v in loaded["fx"].items()}
    vcfg, lcfg = vision.VisionConfig.test_tiny(), decoder_lm.DecoderLMConfig.tiny()
    drawn_lm = decoder_lm.init_params(lcfg, torch.Generator().manual_seed(4))
    drawn_tower = vision.init_params(vcfg, torch.Generator().manual_seed(1))
    chat = [{"role": "user", "content": [{"type": "input_text", "text": "what is in this image"},
                                         {"type": "input_image", "image_url": image_url(32)}]}]

    def run(device) -> dict:
        feats, logits = merged_logits(weights.vision_params(loaded["vision"], device),
                                      weights.tree_to_torch(loaded["lm"], device),
                                      torch.from_numpy(fx["pixels"]).to(device), torch.from_numpy(fx["ids"]).to(device))
        handler = VisionLocalTorchLLMHandler(threading.Event(), Queue(), Queue(), setup_kwargs=dict(
            device=device, model_size="tiny", max_new_tokens=12, params=weights.tree_to_torch(drawn_lm, device),
            vision_config=vcfg, vision_params=weights.tree_to_torch(drawn_tower, device)))
        return {"feats": feats.cpu().numpy(), "logits": logits.cpu().numpy(), "text": list(handler._jax_generate(chat))}

    cpu, card = run("cpu"), run(dev)
    errs = {k: float(np.abs(cpu[k] - card[k]).max()) for k in ("feats", "logits")}
    check(float(np.abs(cpu["feats"] - fx["img_feats"]).max()) <= 2e-4, "tiny tower on the CPU vs the fixture")
    check(max(errs.values()) <= VISION_ATOL, f"tiny tower and merged logits cuda vs cpu {errs}")
    check(np.array_equal(np.argmax(card["logits"], -1), np.argmax(fx["logits"][0], -1)), "merged argmax")
    check(card["text"] == cpu["text"] and cpu["text"], f"tiny VLM stage text cuda vs cpu {card['text']} {cpu['text']}")
    phase("tiny_vlm_parity", max_abs_err=errs, bound=VISION_ATOL, stage_pieces=len(card["text"]))


def tiny_deepfilter_parity_phase(dev: torch.device) -> None:
    """DeepFilter on the card against the CPU: the DFN twin's converted
    weights (``DEEPFILTER_FIXTURE``, tiny) through ``filter_frames``, the
    frames within ``DEEPFILTER_REL`` x max|CPU| (and the JAX package's 2e-5
    of the twin's); then ``DeepFilterConfig()`` drawn from a torch seed:
    ``enhance`` of 3 s of speech-like audio likewise, the same length."""
    from s2s_tpu_torch import weights
    from s2s_tpu_torch.models import deepfilter

    tree, fx = _fixture(DEEPFILTER_FIXTURE)
    tiny, full = deepfilter.DeepFilterConfig.tiny(), deepfilter.DeepFilterConfig()
    drawn = deepfilter.init_params(full, torch.Generator().manual_seed(0))
    spec = torch.from_numpy((fx["spec_re"] + 1j * fx["spec_im"]).astype(np.complex64))
    audio = _speech_like(48_000, torch.Generator().manual_seed(3), "cpu")

    def run(device) -> dict:
        frames, _ = deepfilter.filter_frames(weights.deepfilter_params(tree, device), tiny, spec.to(device),
                                             deepfilter.init_state(tiny, device))
        wav = deepfilter.enhance(weights.tree_to_torch(drawn, device), full, audio.to(device))
        return {"frames": frames.cpu().numpy(), "wav": wav.cpu().numpy()}

    cpu, card = run("cpu"), run(dev)
    rel = {k: float(np.abs(cpu[k] - card[k]).max() / np.abs(cpu[k]).max()) for k in cpu}
    twin = float(np.abs(cpu["frames"] - (fx["out_re"] + 1j * fx["out_im"])).max())
    check(twin <= 2e-5, f"tiny deepfilter on the CPU vs the twin {twin}")
    check(card["wav"].shape == audio.shape and np.isfinite(card["wav"]).all(), "deepfilter keeps the length")
    check(max(rel.values()) <= DEEPFILTER_REL, f"deepfilter cuda vs cpu {rel}")
    phase("tiny_deepfilter_parity", max_abs_err_rel=rel, bound_rel=DEEPFILTER_REL, twin_max_abs_err=twin)


def _wall_ms(fn, reps: int = 3) -> float:
    """Wall time of ``fn()`` to its last kernel, the least of *reps* runs."""
    best = math.inf
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _image_turn(prompt: str, color: str):
    return [(0, {"type": "conversation.item.create", "item": {
        "type": "message", "role": "user", "content": [
            {"type": "input_text", "text": prompt}, {"type": "input_image", "image_url": image_url(color=color)}]}}),
        (0, {"type": "response.create", "response": {}})]


def _reply_text(events) -> str:
    return "".join(e.get("delta", "") for _, e in events
                   if e["type"] in ("response.output_audio_transcript.delta", "response.output_text.delta"))


def _answered_turn(url: str, turns, counts) -> tuple[list | None, list[dict]]:
    """Text turns (label, actions), each its own session, in order until one
    is answered with audio: (that turn's events or None, one summary an
    attempt with its launches, ``counts()`` read and cleared after it).  A
    random-init reply may be unspeakable (bytes that decode to no letter, so
    the TTS has nothing to say)."""
    attempts = []
    for label, actions in turns:
        events = asyncio.run(_session(url, actions, _response_done, 600))
        replied = "response.output_audio.delta" in _types(events)
        attempts.append({"turn": label, "replied": replied, "reply": _reply_text(events)[:60], "counts": counts()})
        if replied:
            return events, attempts
    return None, attempts


def paraformer_vlm_serve_phase(dev: torch.device, card: list[str]) -> dict[str, int]:
    """The single-session serve with Paraformer, the VLM stage and DeepFilter
    (``PARAFORMER_VLM_FLAGS`` with ``--tts facebookMMS`` and
    ``--vad_enhancer_checkpoint``: a ``DeepFilterConfig()`` tree drawn from
    seed 0 written to a temporary ``.npz``): build, every count set to 0,
    then three turns over a real WebSocket, their launches counted turn by
    turn:

    1. a voice turn: a transcription event (a reply, where the random LM
       gives one, is read as far as its first audio); one log-mel launch per
       Paraformer forward (> 0); one DeepFilter call per VAD final (> 0),
       each giving finite audio of its input's length;
    2. a text turn with one ``input_image`` (``image_url``, a PNG written
       here, which the port decodes with PIL; ``IMAGE_PROMPTS`` in turn
       until one is answered): audio deltas and ``response.done``; each
       attempt runs the tower once and the flash kernel ``SIGLIP_LAYERS``
       times; a logged "Failed to decode input_image" fails the phase;
    3. a text turn without an image (``TEXT_PROMPTS`` likewise): answered,
       and no tower run.

    Then, on the served models: one Paraformer forward's device time,
    kernels and wall time at a 3 s window; the tower's device time and the
    flash kernel's share of it; DeepFilter's device and wall time per
    second of audio (3 s).  ``torch.cuda.memory_allocated()`` before the
    build, after shutdown (this phase's references dropped) and after a
    garbage collection.  Returns the kernels' launches over the turns."""
    import shutil
    import tempfile

    import PIL  # the served path decodes input_image data URLs with it

    from s2s_tpu_torch import cli
    from s2s_tpu_torch.llm.utils import image_url_to_pil
    from s2s_tpu_torch.llm.vlm_backend import VisionLocalTorchLLMHandler
    from s2s_tpu_torch.models import deepfilter, paraformer, vision
    from s2s_tpu_torch.pipeline.messages import VADAudio
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE
    from s2s_tpu_torch.stt.paraformer_handler import ParaformerSTTHandler
    from s2s_tpu_torch.tools import convert_checkpoint
    from s2s_tpu_torch.vad.handler import VADHandler

    counters = _launch_counters()
    seen = {"forwards": 0, "encodes": 0, "finals": 0, "enhances": 0, "enhanced": []}
    real_forward, real_encode = paraformer.forward, vision.encode_image
    real_enhance, real_process = deepfilter.DeepFilterEnhancer.__call__, VADHandler.process

    def counted_forward(*args, **kwargs):
        seen["forwards"] += 1
        return real_forward(*args, **kwargs)

    def counted_encode(*args, **kwargs):
        seen["encodes"] += 1
        return real_encode(*args, **kwargs)

    def counted_enhance(self, audio):
        out = real_enhance(self, audio)
        seen["enhances"] += 1
        seen["enhanced"].append((audio.size, out.size, bool(np.isfinite(out).all())))
        return out

    def counted_process(self, item):
        for out in real_process(self, item):
            if isinstance(out, VADAudio) and out.mode == "final":
                seen["finals"] += 1
            yield out

    def turn_counts() -> dict:
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counters.items()}
        counts.update(forwards=seen["forwards"], encodes=seen["encodes"], finals=seen["finals"],
                      enhancer_calls=seen["enhances"])
        for fn in counters.values():
            fn.launches = 0
        seen.update(forwards=0, encodes=0, finals=0, enhances=0)
        return counts

    lines = _Lines()
    vlm_log = logging.getLogger("s2s_tpu_torch.llm.vlm_backend")
    vlm_log.addHandler(lines)
    paraformer.forward, vision.encode_image = counted_forward, counted_encode
    deepfilter.DeepFilterEnhancer.__call__, VADHandler.process = counted_enhance, counted_process
    stop = threading.Event()
    memory = {"before_build": torch.cuda.memory_allocated()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deepfilter_")
    try:
        checkpoint = f"{tmp}/deepfilter.npz"
        np.savez(checkpoint, **convert_checkpoint.flatten(deepfilter.init_params(deepfilter.DeepFilterConfig(),
                                                                                 torch.Generator().manual_seed(0))))
        flags = tts_flags(PARAFORMER_VLM_FLAGS, "facebookMMS") + ["--vad_enhancer_checkpoint", checkpoint]
        t0 = time.perf_counter()
        manager, server, _ = cli.build_from_argv(["--device", "cuda", *flags], stop)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        manager.start()
        try:
            check(server.started.wait(60), "server started")
            url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"
            turn_counts()  # the build's warm-up transcription is not counted
            seen["enhanced"].clear()
            lines.records.clear()
            voice = asyncio.run(_session(url, _audio_turn(), _reply_or_quiet, 300))
            voice_counts, enhanced = turn_counts(), list(seen["enhanced"])
            image, image_attempts = _answered_turn(url, [
                (f"{prompt} ({color})", _image_turn(prompt, color)) for prompt, color in IMAGE_PROMPTS], turn_counts)
            text, text_attempts = _answered_turn(url, [(t, _text_turn(t)) for t in TEXT_PROMPTS], turn_counts)
            failed = [r.getMessage() for r in lines.records if "Failed to decode input_image" in r.getMessage()]

            stt = next(h for h in manager.handlers if isinstance(h, ParaformerSTTHandler))
            llm = next(h for h in manager.handlers if isinstance(h, VisionLocalTorchLLMHandler))
            vad = next(h for h in manager.handlers if isinstance(h, VADHandler))
            pcfg, pparams = stt._paraformer_cfg, stt._paraformer_params
            feats = torch.randn(1, pcfg.max_frames, pcfg.input_size, generator=torch.Generator().manual_seed(2))
            feats, n_valid = feats.to(dev), torch.tensor([50], dtype=torch.int32, device=dev)
            _, fwd_ms, fwd_kernels, fwd_copies = _device_activity(lambda: real_forward(pparams, pcfg, feats, n_valid))
            fwd_wall = _wall_ms(lambda: real_forward(pparams, pcfg, feats, n_valid))
            pixels = torch.from_numpy(vision.preprocess_image(image_url_to_pil(image_url()),
                                                           llm.vision_cfg.image_size))
            pixels = pixels.to(dev)
            _, tower_events = _device_events(lambda: real_encode(llm.vision_params, llm.vision_cfg, pixels))
            tower_wall = _wall_ms(lambda: real_encode(llm.vision_params, llm.vision_cfg, pixels))
            audio = _speech_like(48_000, torch.Generator().manual_seed(4), "cpu").numpy()
            _, df_ms, df_kernels, _ = _device_activity(lambda: real_enhance(vad.enhancer, audio))
            df_wall = _wall_ms(lambda: real_enhance(vad.enhancer, audio))
        finally:
            stop.set()
            manager.stop()
            GLOBAL_MODEL_CACHE.clear()
        n_patches = llm.vision_cfg.n_patches
        del manager, server, stt, llm, vad, pparams  # what this phase holds of the serve
        torch.cuda.synchronize()
        memory["after_shutdown"] = torch.cuda.memory_allocated()
        gc.collect()
        memory["after_gc"] = torch.cuda.memory_allocated()
    finally:
        paraformer.forward, vision.encode_image = real_forward, real_encode
        deepfilter.DeepFilterEnhancer.__call__, VADHandler.process = real_enhance, real_process
        vlm_log.removeHandler(lines)
        shutil.rmtree(tmp, ignore_errors=True)

    transcripts = _transcripts(voice)
    check(len(transcripts) >= 1, f"voice turn: a transcription event {_types(voice)}")
    summary = {"transcript": transcripts[0][1][:80], "transcription_s": transcripts[0][0],
               "replied": "response.output_audio.delta" in _types(voice)}
    if summary["replied"]:
        summary["first_audio_s"] = _first_audio_s(voice)
    check(voice_counts["log_mel"] > 0 and voice_counts["log_mel"] == voice_counts["forwards"],
          f"voice turn: one log-mel launch per Paraformer forward (> 0): {voice_counts}")
    check(voice_counts["finals"] > 0 and voice_counts["enhancer_calls"] == voice_counts["finals"],
          f"voice turn: one DeepFilter call per VAD final (> 0): {voice_counts}")
    check(all(n_in == n_out and finite for n_in, n_out, finite in enhanced), f"DeepFilter outputs {enhanced}")
    check(not failed, f"the image was decoded: {failed}")
    for a in image_attempts:
        check(a["counts"]["encodes"] == 1 and a["counts"]["flash_attention"] == SIGLIP_LAYERS,
              f"image turn: one tower run, {SIGLIP_LAYERS} flash launches a run: {a}")
    for a in text_attempts:
        check(a["counts"]["encodes"] == 0 and a["counts"]["flash_attention"] == 0, f"text turn ran no tower {a}")
    check(image is not None and text is not None,
          f"an image turn and a text turn answered with audio: {image_attempts} {text_attempts}")
    image_pcm, image_done = _reply(image, "image turn")
    text_pcm, text_done = _reply(text, "text turn")
    tower_ms, by_kernel = _busy_ms(tower_events), {}
    for e in tower_events:
        by_kernel[e.name()[:60]] = by_kernel.get(e.name()[:60], 0.0) + e.duration_ns() / 1e6
    flash_ms = sum(ms for name, ms in by_kernel.items() if "flash_attention" in name)
    launches = {k: voice_counts[k] + sum(a["counts"][k] for a in image_attempts + text_attempts) for k in counters}
    phase("paraformer_vlm_serve", card=card, flags=flags[flags.index("--stt"):], image_decoder=f"PIL {PIL.__version__}",
          build_s=build_s, voice_turn=summary, transcriptions=voice_counts["forwards"],
          vad_finals=voice_counts["finals"], enhanced_samples=[e[0] for e in enhanced],
          image_turn={"ttfa_s": _first_audio_s(image), "done_s": image_done, "audio_seconds": image_pcm.size / 24_000},
          text_turn={"ttfa_s": _first_audio_s(text), "done_s": text_done, "audio_seconds": text_pcm.size / 24_000},
          voice_launches=voice_counts, image_attempts=image_attempts, text_attempts=text_attempts,
          paraformer_forward={"frames": pcfg.max_frames, "valid_frames": 50, "device_ms": fwd_ms,
                              "kernels": fwd_kernels, "copies": fwd_copies, "wall_ms": fwd_wall},
          tower={"patches": n_patches, "device_ms": tower_ms, "flash_ms": flash_ms,
                 "flash_share": flash_ms / tower_ms if tower_ms else None, "wall_ms": tower_wall,
                 "kernels": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])},
          deepfilter={"audio_seconds": audio.size / 16_000, "device_ms_per_audio_s": df_ms / 3,
                      "wall_ms_per_audio_s": df_wall / 3, "kernels": df_kernels},
          memory_allocated=memory)
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


def _train_batch(rng: np.random.Generator, rows: int, t: int, vocab: int) -> tuple[torch.Tensor, ...]:
    """(tokens, targets = tokens rolled by one, mask) from a numpy seed; the
    mask drops the wrapped last target and, in row 1, the first 3."""
    tokens = rng.integers(0, vocab, (rows, t)).astype(np.int32)
    mask = np.ones((rows, t), np.int32)
    mask[:, -1] = 0
    mask[1 % rows, :3] = 0
    return tuple(torch.from_numpy(a) for a in (tokens, np.roll(tokens, -1, axis=1), mask))


def _full(tree) -> dict[str, np.ndarray]:
    """A (DTensor) parameter tree's leaves, whole, as host f32 arrays by path."""
    from torch.distributed.tensor import DTensor

    return {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach().float().cpu().numpy()
            for k, v in _leaves(tree).items()}


def _leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def tiny_train_parity_phase(dev: torch.device) -> None:
    """The tiny f32 decoder's training path on the card against the CPU:
    three AdamW steps through ``make_sharded_train_step`` on a 1 x 1 mesh of
    each device and three ``sgd_train_step``s, from the same parameters and
    batch; losses and every parameter leaf within ``TINY_TRAIN_REL`` x
    max|CPU| (the CPU path is held against the JAX package by
    ``tests/test_torch_port_training.py``)."""
    from s2s_tpu_torch.models import decoder_lm
    from s2s_tpu_torch.parallel import mesh, training

    cfg = decoder_lm.DecoderLMConfig.tiny()
    params = decoder_lm.init_params(cfg, torch.Generator().manual_seed(4))
    batch = _train_batch(np.random.default_rng(4), 4, 16, cfg.vocab_size)
    out = {}
    for label, device_type, device in (("cuda", "cuda", dev), ("cpu", "cpu", "cpu")):
        init_fn, run_step = training.make_sharded_train_step(cfg, mesh.make_mesh(device_type=device_type))
        state = init_fn(params=params)
        adam = []
        for _ in range(TRAIN_STEPS):
            loss, state = run_step(state, *batch)
            adam.append(float(loss))
        sgd_params, sgd = pytree.tree_map(lambda t: t.to(device), params), []
        for _ in range(TRAIN_STEPS):
            loss, sgd_params = decoder_lm.sgd_train_step(sgd_params, cfg, *(t.to(device) for t in batch), lr=1e-2)
            sgd.append(float(loss))
        check(int(state.step) == TRAIN_STEPS and int(state.opt_state.count) == TRAIN_STEPS,
              f"tiny train {label}: step {int(state.step)}, count {int(state.opt_state.count)}")
        out[label] = {"adam": (adam, _full(state.params)), "sgd": (sgd, _full(sgd_params))}
    errs = {}
    for kind in ("adam", "sgd"):
        (ref_losses, ref), (losses, got) = out["cpu"][kind], out["cuda"][kind]
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], f"tiny {kind} losses {losses}")
        loss_err = max(abs(a - b) / abs(a) for a, b in zip(ref_losses, losses))
        check(loss_err <= TINY_TRAIN_REL, f"tiny {kind} losses cuda {losses} vs cpu {ref_losses}")
        errs[kind] = max(float(np.abs(ref[k] - got[k]).max() / np.abs(ref[k]).max()) for k in ref)
        check(errs[kind] <= TINY_TRAIN_REL, f"tiny {kind} parameters cuda vs cpu rel {errs[kind]}")
        errs[f"{kind}_losses"] = losses
    phase("tiny_train_parity", steps=TRAIN_STEPS, adam_param_rel_err=errs["adam"], sgd_param_rel_err=errs["sgd"],
          adam_losses=errs["adam_losses"], sgd_losses=errs["sgd_losses"], bound=TINY_TRAIN_REL)


def train_phase(dev: torch.device, card: list[str]) -> dict:
    """Full-width SmolLM2-1.7B (random weights from a seed) takes
    ``TRAIN_STEPS`` AdamW steps on a 1 x 1 mesh of the card through
    ``make_sharded_train_step`` on a ``TRAIN_BATCH`` batch from a numpy
    seed: each step's loss (finite, the last below the first), wall time
    and device time (CUDA events from the step's first launch to its last
    kernel), the last step's kernels and device busy time under
    ``torch.profiler`` (its wall time then includes the profiler's cost),
    the peak allocation; the hand-written kernels must not launch (the
    training path reaches none).  Then scoring against serving: ``forward``
    over a ``SCORE_PROMPT``-token prompt at its last position against
    ``prefill``'s logits, within ``SCORE_ULPS`` bf16 ulps of max|prefill|."""
    from s2s_tpu_torch.models import decoder_lm
    from s2s_tpu_torch.parallel import mesh, training

    cfg = decoder_lm.DecoderLMConfig.smollm2_1_7b()
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    the_mesh = mesh.make_mesh()
    init_fn, run_step = training.make_sharded_train_step(cfg, the_mesh, lr=TRAIN_LR)
    state = init_fn(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = tuple(t.to(dev) for t in _train_batch(np.random.default_rng(0), *TRAIN_BATCH, cfg.vocab_size))
    steps = []
    for i in range(TRAIN_STEPS):
        profiled = i == TRAIN_STEPS - 1
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        if profiled:
            (loss, state), device = _device_events(lambda: run_step(state, *batch))
        else:
            loss, state = run_step(state, *batch)
        end.record()
        loss = float(loss)
        torch.cuda.synchronize()
        step = {"step": i + 1, "loss": loss, "wall_s": time.perf_counter() - t, "device_ms": start.elapsed_time(end)}
        if profiled:
            kernels = [e for e in device if not e.name().startswith(("Memcpy", "Memset"))]
            by_name: dict[str, float] = {}
            for e in kernels:
                by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            step.update(profiled=True, busy_ms=_busy_ms(device), kernels=len(kernels),
                        copies_and_memsets=len(device) - len(kernels),
                        top_kernels=[{"name": n[:120], "ms": ms} for n, ms in top])
        steps.append(step)
        phase("train_step", card=card, **step)
    peak = torch.cuda.max_memory_allocated() - base
    launches = {name: fn.launches for name, fn in counters.items()}
    losses = [s["loss"] for s in steps]
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train: step {TRAIN_STEPS}'s loss {losses[-1]} is not below step 1's {losses[0]}")
    check(int(state.step) == TRAIN_STEPS, f"train step count {int(state.step)}")
    check(not any(launches.values()), f"train: hand-written kernels launched {launches}")

    # scoring ties to serving: the trained weights, whole on the one card
    params = pytree.tree_map(lambda t: t.to_local(), state.params)
    del state
    prompt = batch[0][:1, :SCORE_PROMPT]
    with torch.no_grad():
        scored = decoder_lm.forward(params, cfg, prompt)[:, SCORE_PROMPT - 1]
        served, _ = decoder_lm.prefill(params, cfg, prompt, decoder_lm.init_decode_state(
            cfg, 1, max_t=SCORE_PROMPT, device=dev), SCORE_PROMPT)
    top = served.abs().max().item()
    score_err = (scored - served).abs().max().item()
    check(score_err <= SCORE_ULPS * bf16_ulp(top),
          f"forward[:, p-1] vs prefill: {score_err} > {SCORE_ULPS} bf16 ulps of {top}")
    result = {"config": "smollm2_1_7b", "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
              "batch": list(TRAIN_BATCH), "lr": TRAIN_LR, "mesh": list(the_mesh.mesh.shape), "init_s": init_s,
              "losses": losses, "wall_s": [s["wall_s"] for s in steps], "device_ms": [s["device_ms"] for s in steps],
              "peak_allocated_bytes": peak, "kernel_launches": launches, "score_max_abs_err": score_err,
              "score_bound": SCORE_ULPS * bf16_ulp(top), "card": card}
    phase("train", **result)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return result


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
    seconds: dict[str, float] = {}

    def run(name: str, fn, *args, tf32: bool = True):
        """Run one phase (with TF32 off unless *tf32*; a serve of
        ``SERVE_DEPTHS`` at its depths), keeping its seconds; after a serve,
        what stays allocated on the card (before and after a garbage
        collection)."""
        t0 = time.perf_counter()
        depth = served_depth(*SERVE_DEPTHS[name]) if name in SERVE_DEPTHS else contextlib.nullcontext()
        with contextlib.nullcontext() if tf32 else tf32_mode(False), depth:
            result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        if name.endswith("serve"):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            gc.collect()
            phase("serve_memory", serve=name, allocated_bytes=held, after_gc_bytes=torch.cuda.memory_allocated())
        return result

    t0 = time.perf_counter()
    library, _ = _build.build()
    seconds["build"] = time.perf_counter() - t0
    phase("build", library=str(library.name), seconds=_build.build_seconds)
    int8 = run("int8_matmul", weight_only_phase, dev, "int8", tf32=False)
    attn = run("decode_attention", attention_phase, dev, tf32=False)
    run("tiny_parity", tiny_parity_phase, dev, tf32=False)
    run("tiny_batched_parity", tiny_batched_parity_phase, dev, tf32=False)
    tp_parity = run("tp_parity", tp_parity_phase, dev, tf32=False)
    run("tiny_kokoro_parity", tiny_kokoro_parity_phase, dev, tf32=False)
    run("tiny_vits_parity", tiny_vits_parity_phase, dev, tf32=False)
    run("tiny_pocket_parity", tiny_pocket_parity_phase, dev, tf32=False)
    run("tiny_chattts_parity", tiny_chattts_parity_phase, dev, tf32=False)
    run("tiny_paraformer_parity", tiny_paraformer_parity_phase, dev, tf32=False)
    run("tiny_vlm_parity", tiny_vlm_parity_phase, dev, tf32=False)
    run("tiny_deepfilter_parity", tiny_deepfilter_parity_phase, dev, tf32=False)
    run("convert_parity", convert_parity_phase, dev, tf32=False)
    # under torch's defaults, as the serve runs it; before any other profiler session in this process (a
    # profiler started after the traced round's dropped some or all of a tick's device events on an H100)
    run("silero", silero_phase, dev, smi)
    # the Kokoro, MMS, Pocket and ChatTTS cascades, under torch's defaults as the CLI serves them; their
    # per-synthesis profiles come before the traced round's profiler session, as Silero's do
    tts = {name: run(TTS_SERVES[name][0], tts_serve_phase, dev, smi, name) for name in TTS_SERVES}
    single = run("serve", serve_phase, dev)
    launches = run("batched_serve", batched_serve_phase, dev, smi)
    tp_launches = run("tp_serve", tp_serve_phase, dev, smi, tp_parity)
    dyn = run("int8_matmul_dyn", int8_dyn_phase, dev, str(library), tf32=False)
    int4 = run("int4_matmul", weight_only_phase, dev, "int4", tf32=False)
    micro = run("w8a8_microbench", w8a8_microbench_phase, dev, dyn["rows"], tf32=False)
    run("tiny_quant_parity", tiny_quant_parity_phase, dev, tf32=False)
    quant_launches = run("quant_serve", quant_serve_phase, dev, smi)
    flash = run("flash_attention", flash_attention_phase, dev, tf32=False)
    logmel = run("log_mel", log_mel_phase, dev, tf32=False)
    run("tiny_whisper_parity", tiny_whisper_parity_phase, dev, tf32=False)
    whisper_launches = run("whisper_serve", whisper_serve_phase, dev, smi)
    # the new paths run under torch's defaults, as the serve does
    run("head_logits", head_logits_phase, dev, smi)
    run("resample", resample_phase, dev)
    deployment = run("deployment_serve", deployment_serve_phase, dev, smi)
    # the backends ported last, after every other serve, under torch's defaults
    vlm = run("paraformer_vlm_serve", paraformer_vlm_serve_phase, dev, smi)
    # the decoder LM's training path, last: a process group of world size 1 for its meshes
    run("tiny_train_parity", tiny_train_parity_phase, dev, tf32=False)
    run("train", train_phase, dev, smi)
    phase("seconds", **seconds)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    mel_launches = {"whisper_serve": whisper_launches["log_mel"], "serve": single["parakeet_log_mel"],
                    "batched_serve": launches["parakeet_log_mel"],
                    **{TTS_SERVES[t][0]: tts[t]["parakeet_log_mel"] for t in TTS_SERVES},
                    "paraformer_vlm_serve": vlm["log_mel"]}
    flash_launches = {"whisper_serve": whisper_launches["flash_attention"],
                      "paraformer_vlm_serve": vlm["flash_attention"]}
    tts_serves = {name: {f"{TTS_SERVES[t][0]}_launches": tts[t][name] for t in TTS_SERVES}
                  for name in ("int8_matmul", "decode_attention")}
    for name in tts_serves:  # the tensor-parallel serve's, leader then follower
        tts_serves[name]["tp_serve_launches_by_rank"] = tp_launches[name]
    print(smi[0])
    print(json.dumps({"kernels": [
        {"name": "int8_matmul", "route": "cuda", "source": "s2s_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "s2s_tpu/ops/int8_matmul.py:39", "launches": launches["int8_matmul"],
         "deployment_serve_launches": deployment["int8_matmul"], **tts_serves["int8_matmul"],
         "whisper_serve_launches": whisper_launches["int8_matmul"],
         "whisper_serve_lm_launches": whisper_launches["int8_matmul_lm"],
         **{k: int8[k] for k in keys}},
        {"name": "decode_attention", "route": "cuda", "source": "s2s_tpu_torch/csrc/decode_attention.cu",
         "replaces": "s2s_tpu/ops/decode_attention.py:44", "launches": launches["decode_attention"],
         "deployment_serve_launches": deployment["decode_attention"], **tts_serves["decode_attention"],
         **{k: attn[k] for k in keys}},
        {"name": "int8_matmul_dyn", "route": "cuda", "source": "s2s_tpu_torch/csrc/int8_matmul_dyn.cu",
         "replaces": "s2s_tpu/ops/int8_matmul.py:80", "launches": quant_launches["int8_matmul_dyn"],
         **{k: dyn[k] for k in keys}},
        {"name": "int4_matmul", "route": "cuda", "source": "s2s_tpu_torch/csrc/int4_matmul.cu",
         "replaces": "s2s_tpu/ops/int4_matmul.py:74", "launches": quant_launches["int4_matmul"],
         **{k: int4[k] for k in keys}},
        # both callers: the Whisper and Smart Turn encoders, SigLIP's tower
        {"name": "flash_attention", "route": "cuda", "source": "s2s_tpu_torch/csrc/flash_attention.cu",
         "replaces": "s2s_tpu/ops/pallas_attention.py:68", "launches": sum(flash_launches.values()),
         "launches_by_caller": flash_launches, **{k: flash[k] for k in keys}, "siglip": flash["siglip"]},
        # its callers: the Whisper cell's and Paraformer's log-mels, the Parakeet cells' frontends
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
