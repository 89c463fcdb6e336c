"""Parity: the port's cross-session batched engine against the JAX package.

Tiny f32 configs from the JAX ``init_params`` cross through
``s2s_tpu_torch.weights``; prompts, texts and audio come from a numpy seed.

- LM tail programs (``s2s_tpu_torch.parallel.batched_decode``): tokens,
  emitted masks and next tokens equal, positions equal, caches within
  1e-5 * max|ref| over every row's valid prefix; including a mid-chunk EOS,
  a width bucket padded with a repeated slot id, and int8 weights.
- Qwen3-TTS talker tail programs: codes (carried in the vocoder contexts) and
  EOS flags equal, audio within 1e-4 * max|ref|.
- ``transcribe_step_batch`` with a padding row: tokens equal.
- Scheduler level: three concurrent sessions through the port's engines and
  through the JAX engines with identical prompts give equal token streams
  and audio chunks within 1e-4 * max|ref|.
- The batched Parakeet service's ``warmup`` defaults lengths and widths each
  on its own.
"""

import os
import threading

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.models import decoder_lm as jdl  # noqa: E402
from s2s_tpu.models import parakeet as jpk  # noqa: E402
from s2s_tpu.models import qwen3_tts as jq  # noqa: E402
from s2s_tpu.ops.quant import quantize_tree as jax_quantize_tree  # noqa: E402
from s2s_tpu.parallel import batched_decode as jbd  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import decoder_lm as tdl  # noqa: E402
from s2s_tpu_torch.models import parakeet as tpk  # noqa: E402
from s2s_tpu_torch.models import qwen3_tts as tq  # noqa: E402
from s2s_tpu_torch.ops.quant import quantize_tree  # noqa: E402
from s2s_tpu_torch.parallel import batched_decode as tbd  # noqa: E402

N_SLOTS, MAX_T = 3, 32


def _close(ref, got, rel):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if ref.size:
        np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def _equal(ref, got):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _states_match(jstate, tstate):
    """Positions equal; caches within 1e-5 at every row's valid positions
    (garbage past a row's position is unspecified on both sides)."""
    _equal(jstate.pos, tstate.pos.numpy())
    for row, p in enumerate(np.asarray(jstate.pos)):
        for jc, tc in ((jstate.caches.k, tstate.caches.k), (jstate.caches.v, tstate.caches.v)):
            _close(np.asarray(jc)[:, row, :, :p], tc[:, row, :, :p].numpy(), 1e-5)


def _lm(quant: bool, key: int = 7):
    jcfg, tcfg = jdl.DecoderLMConfig.tiny(), tdl.DecoderLMConfig.tiny()
    jp = jdl.init_params(jax.random.PRNGKey(key), jcfg)
    tp = weights.tree_to_torch(jp, "cpu")
    if quant:
        jp, tp = jax_quantize_tree(jp, min_size=1), quantize_tree(tp, min_size=1)
    return jcfg, jp, tcfg, tp


def _staggered(jcfg, jp, tcfg, tp):
    """Both batched states with slots prefilled to different positions."""
    js = jbd.init_multi_state(jcfg, N_SLOTS, max_t=MAX_T)
    ts = tbd.init_multi_state(tcfg, N_SLOTS, max_t=MAX_T)
    rng = np.random.default_rng(11)
    for slot, plen in enumerate((5, 1, 3)):
        prompt = rng.integers(1, jcfg.vocab_size, (1, 8)).astype(np.int32)
        jtok, js = jbd.prefill_slot(jp, jcfg, jnp.asarray(prompt), jnp.asarray(plen, jnp.int32), js,
                                    jnp.asarray(slot, jnp.int32))
        ttok, ts = tbd.prefill_slot(tp, tcfg, torch.from_numpy(prompt), plen, ts, slot)
        assert int(jtok) == int(ttok)
    _states_match(js, ts)
    return js, ts


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_gathered_tail_matches_jax_with_midchunk_eos_and_padding(quant):
    jcfg, jp, tcfg, tp = _lm(quant)
    js, ts = _staggered(jcfg, jp, tcfg, tp)
    tokens = np.array([4, 9, 9, 9], np.int32)
    ids = np.array([0, 2, 2, 2], np.int32)  # width bucket 4 padded with the last id
    ref = jbd.decode_chunk_gathered_tail(jp, jcfg, jnp.asarray(tokens), js, 6, -1, jnp.asarray(ids))
    eos = int(np.asarray(ref[0])[2, 1])  # row 1 stops mid-chunk
    want = jbd.decode_chunk_gathered_tail(jp, jcfg, jnp.asarray(tokens), js, 6, eos, jnp.asarray(ids))
    got = tbd.decode_chunk_gathered_tail(tp, tcfg, torch.from_numpy(tokens), ts, 6, eos,
                                         torch.from_numpy(ids).long())
    assert not np.asarray(want[1])[-1, 1]  # the EOS row is no longer emitting
    for i in range(3):  # toks, emitted, next tokens
        _equal(want[i], got[i].numpy())
    _states_match(want[3], got[3])


def test_slot_tail_and_fused_prefill_match_jax():
    jcfg, jp, tcfg, tp = _lm(False, key=9)
    js, ts = _staggered(jcfg, jp, tcfg, tp)
    want = jbd.decode_chunk_slot_tail(jp, jcfg, jnp.asarray(5, jnp.int32), js, 4, -1, jnp.asarray(1, jnp.int32))
    got = tbd.decode_chunk_slot_tail(tp, tcfg, torch.tensor(5, dtype=torch.int32), ts, 4, -1, 1)
    for i in range(3):
        _equal(want[i], got[i].numpy())
    _states_match(want[3], got[3])

    prompt = np.random.default_rng(42).integers(1, jcfg.vocab_size, (1, 8)).astype(np.int32)
    want = jbd.prefill_and_chunk_slot_tail(jp, jcfg, jnp.asarray(prompt), jnp.asarray(6, jnp.int32), want[3],
                                           jnp.asarray(2, jnp.int32), 5, -1)
    got = tbd.prefill_and_chunk_slot_tail(tp, tcfg, torch.from_numpy(prompt), 6, got[3], 2, 5, -1)
    for i in range(3):
        _equal(want[i], got[i].numpy())
    _states_match(want[3], got[3])


@pytest.fixture(scope="module")
def tts():
    jcfg, tcfg = jq.Qwen3TTSConfig.tiny(), tq.Qwen3TTSConfig.tiny()
    jp = jq.init_params(jax.random.PRNGKey(2), jcfg)
    return jcfg, jp, tcfg, weights.qwen3_tts_params(jp, "cpu")


def _text(seed: int, n: int = 12, bucket: int = 16) -> np.ndarray:
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :n] = np.random.default_rng(seed).integers(1, 256, n)
    return ids


def test_tts_tail_programs_match_jax(tts):
    """Fused prefill + first ramp chunk for two slots, a ramp chunk in the
    priority lane, then a steady chunk over a padded gathered batch."""
    jcfg, jp, tcfg, tp = tts
    ctx_frames = 4
    js = jbd.init_multi_state(jcfg.lm, N_SLOTS, max_t=64)
    ts = tbd.init_multi_state(tcfg.lm, N_SLOTS, max_t=64)
    jctx = jnp.zeros((N_SLOTS, ctx_frames, jcfg.n_q), jnp.int32)
    tctx = torch.zeros((N_SLOTS, ctx_frames, tcfg.n_q), dtype=torch.int32)
    jemb = jnp.zeros((N_SLOTS, jcfg.lm.d_model), jnp.float32)
    temb = torch.zeros((N_SLOTS, tcfg.lm.d_model))
    for slot, seed in ((1, 1), (0, 2)):
        text = _text(seed)
        spk = np.array([seed], np.int32)
        ja, je, jembs, js, jctx = jq.jit_prefill_and_first_chunk_slot_tail(
            jp, jcfg, jnp.asarray(text), jp["speakers"][jnp.asarray(spk)], js, jctx, 2, jnp.asarray(slot, jnp.int32))
        ta, te, tembs, ts, tctx = tq.prefill_and_first_chunk_slot_tail(
            tp, tcfg, torch.from_numpy(text), tp["speakers"][torch.from_numpy(spk).long()], ts, tctx, 2, slot)
        _close(ja, ta, 1e-4)
        _equal(je, te.numpy())
        _equal(jctx, tctx.numpy())
        jemb, temb = jemb.at[slot].set(jembs), temb.clone()
        temb[slot] = tembs
        _close(jemb, temb, 1e-5)
    _states_match(js, ts)

    ja, je, je1, js, jc1 = jq.jit_decode_chunk_audio_slot_tail(jp, jcfg, jemb[1], js, jctx[1], 4, jnp.asarray(1, jnp.int32))
    ta, te, te1, ts, tc1 = tq.decode_chunk_audio_slot_tail(tp, tcfg, temb[1], ts, tctx[1], 4, 1)
    _close(ja, ta, 1e-4)
    _equal(je, te.numpy())
    _equal(jc1, tc1.numpy())
    jemb, jctx = jemb.at[1].set(je1), jctx.at[1].set(jc1)
    temb[1], tctx[1] = te1, tc1

    ids = np.array([0, 1, 1, 1], np.int32)
    want = jq.jit_decode_chunk_audio_gathered_tail(jp, jcfg, jemb, js, jctx, 3, jnp.asarray(ids))
    got = tq.decode_chunk_audio_gathered_tail(tp, tcfg, temb, ts, tctx, 3, torch.from_numpy(ids).long())
    _close(want[0], got[0], 1e-4)
    _equal(want[1], got[1].numpy())
    _close(want[2], got[2], 1e-5)
    _states_match(want[3], got[3])
    _equal(want[4], got[4].numpy())


def test_transcribe_step_batch_matches_jax_with_a_padding_row():
    jcfg, tcfg = jpk.ParakeetConfig.test_tiny(), tpk.ParakeetConfig.test_tiny()
    jp = jpk.init_params(jax.random.PRNGKey(2), jcfg)
    tp = weights.parakeet_params(jp, "cpu")
    rng = np.random.default_rng(1)
    audio = (0.3 * rng.standard_normal((3, 24_000))).astype(np.float32)
    n_valid = np.array([24_000, 16_000, 0], np.int32)
    audio[1, 16_000:] = 0.0
    audio[2] = 0.0
    jtoks, jn = jpk.transcribe_step_batch(jp, jcfg, jnp.asarray(audio), jnp.asarray(n_valid))
    want = [[int(t) for t in np.asarray(jtoks)[i, : int(np.asarray(jn)[i])]] for i in range(3)]
    got = tpk.transcribe_step_batch(tp, tcfg, torch.from_numpy(audio), n_valid.tolist())
    assert got == want and want[2] == [] and want[0], want


def _concurrently(fn, n: int) -> list:
    results: list = [None] * n

    def run(i):
        results[i] = fn(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return results


PROMPTS = [[3, 7, 11, 2], [40, 41, 42, 43, 44, 45], [60, 2, 33, 12, 9]]


def test_lm_schedulers_stream_equal_tokens_for_concurrent_sessions():
    from s2s_tpu.parallel.session_scheduler import BatchedLMScheduler as JaxEngine
    from s2s_tpu_torch.parallel.session_scheduler import BatchedLMScheduler

    jcfg, jp, tcfg, tp = _lm(False, key=0)
    kw = dict(n_slots=4, max_t=64, eos_id=0, chunk_tokens=4, priority_tokens=3)
    streams = {}
    for name, engine in (("jax", JaxEngine(jp, jcfg, **kw)), ("port", BatchedLMScheduler(tp, tcfg, **kw))):
        try:
            streams[name] = _concurrently(lambda i: list(engine.generate(PROMPTS[i], max_new=10)), 3)
        finally:
            engine.shutdown()
    assert streams["port"] == streams["jax"] and all(streams["jax"])


def test_tts_schedulers_stream_equal_audio_for_concurrent_sessions(tts):
    from s2s_tpu.parallel.session_scheduler import BatchedTTSScheduler as JaxEngine
    from s2s_tpu_torch.parallel.session_scheduler import BatchedTTSScheduler

    jcfg, jp, tcfg, tp = tts
    kw = dict(n_slots=4, max_t=64, context_frames=8, chunk_frames=3)
    chunks = {}
    for name, engine, params, index in (
            ("jax", JaxEngine(jp, jcfg, **kw), jp, lambda i: jnp.asarray([i])),
            ("port", BatchedTTSScheduler(tp, tcfg, **kw), tp, lambda i: torch.tensor([i]))):
        try:
            chunks[name] = _concurrently(
                lambda i: [a for a, _ in engine.stream(_text(10 + i), params["speakers"][index(i)], 9)], 3)
        finally:
            engine.shutdown()
    for want, got in zip(chunks["jax"], chunks["port"]):
        assert [len(a) for a in got] == [len(a) for a in want] and len(want) >= 3
        for wa, ga in zip(want, got):
            _close(wa, ga, 1e-4)


def test_batched_parakeet_warmup_defaults_each_bucket_set_on_its_own(monkeypatch):
    from s2s_tpu_torch.runtime.batcher import LONG_S, SHORT_S, BatchedParakeetSTT

    service = BatchedParakeetSTT(None, tpk.ParakeetConfig.test_tiny(), max_batch=4)
    calls = []
    monkeypatch.setattr(service, "_transcribe", lambda batch, nv: calls.append(batch.shape))
    widths = [1, 2, 4]
    lengths = [s * 16000 for s in SHORT_S + LONG_S]

    service.warmup(lengths=(8000,))
    assert calls == [(w, 8000) for w in widths]
    calls.clear()
    service.warmup(widths=(2,))
    assert calls == [(2, n) for n in lengths]
    calls.clear()
    service.warmup(lengths=(8000, 16000), widths=(3,))
    assert calls == [(3, 8000), (3, 16000)]
    calls.clear()
    service.warmup()
    want = [(w, s * 16000) for s in SHORT_S for w in widths] + [(w, s * 16000) for s in LONG_S for w in (1, 4)]
    assert calls == want
    service.close()


def test_llm_handler_speculation_and_prompt_fit_reach_the_port_engine():
    """The inherited speculative start and prompt-capacity fit drive the
    port's engine: a speculation on the progressive text is adopted by the
    real turn (the engine's generate() never runs) and the reply equals the
    JAX handler's on the JAX engine with the same weights."""
    from queue import Queue

    from s2s_tpu.llm import chat as jchat
    from s2s_tpu.llm.local_backend import LocalJAXLLMHandler
    from s2s_tpu.parallel.session_scheduler import BatchedLMScheduler as JaxEngine
    from s2s_tpu.pipeline import messages as jmsg
    from s2s_tpu.realtime import config as jconfig
    from s2s_tpu_torch.llm.chat import make_user_message
    from s2s_tpu_torch.llm.local_backend import LocalTorchLLMHandler
    from s2s_tpu_torch.parallel.session_scheduler import BatchedLMScheduler
    from s2s_tpu_torch.pipeline.messages import GenerateResponseRequest, LLMResponseChunk, SpeculativeGenerateRequest
    from s2s_tpu_torch.realtime.config import RuntimeConfig

    jcfg, jp, tcfg, tp = _lm(False, key=0)
    kw = dict(n_slots=2, max_t=64, eos_id=0, chunk_tokens=4)
    jengine, tengine = JaxEngine(jp, jcfg, **kw), BatchedLMScheduler(tp, tcfg, **kw)
    common = dict(model_size="tiny", max_new_tokens=8, speculative_prefill=True)
    jh = LocalJAXLLMHandler(threading.Event(), Queue(), Queue(),
                            setup_kwargs=dict(params=jp, shared_lm=jengine, **common))
    th = LocalTorchLLMHandler(threading.Event(), Queue(), Queue(),
                              setup_kwargs=dict(params=tp, shared_lm=tengine, device="cpu", **common))

    def reply(outs, chunk_type=LLMResponseChunk):
        return "".join(o.text for o in outs if isinstance(o, chunk_type))

    try:
        head = list(range(1, 200))[: tcfg.max_seq_len - 8 - 1]  # the model-context cut comes first
        assert th._fit_prompt(list(range(1, 200)), 8) == head[-tengine.prompt_capacity(8):]
        # each handler gets its own package's messages
        jrc = jconfig.RuntimeConfig()
        jrc.chat.add_item(jchat.make_user_message("hi"))
        want = reply(jh.process(jmsg.GenerateResponseRequest(runtime_config=jrc)), jmsg.LLMResponseChunk)

        rc = RuntimeConfig()
        assert list(th.process(SpeculativeGenerateRequest(runtime_config=rc, text="hi", turn_id="t",
                                                          turn_revision=0))) == []
        assert th._spec is not None

        def boom(*a, **k):
            raise AssertionError("generate() must not run on adoption")

        tengine.generate = boom
        rc.chat.add_item(make_user_message("hi"))
        got = reply(th.process(GenerateResponseRequest(runtime_config=rc, turn_id="t", turn_revision=0)))
        assert got == want and want and th._spec is None
    finally:
        jengine.shutdown()
        tengine.shutdown()
