"""Parity: s2s_tpu_torch.ops.decode_attention against the JAX package.

- ``concat_attention_reference`` against ``batched_decode._concat_attention``
  (the serving programs' attention): within 1e-5 * max|ref| in f32, GQA
  groups of 1 and 2, lengths from a seed with one row at the full cache.
- The port's ``decode_attention`` (plain, CPU) against the Pallas kernel
  ``s2s_tpu.ops.decode_attention.decode_attention`` in interpret mode, as
  ``tests/test_batched_decode.py`` runs it: output within 1e-5 * max|ref|,
  caches equal after the in-place slot write.
- The kernel's key split: :func:`split_ranges` covers [0, nk) disjointly in
  rank order and reads nk alone; :func:`launch_plan` follows (B, KV, SMs)
  and the shared memory a CTA's keys need, streams keys that do not fit at
  once through a ring of tiles, lays out regions that hold what the kernel
  puts there, and plans a launch for every model, cache length and batch
  the batched engines accept.
- A torch model of the cluster's combine (per-range max and sum, the global
  max and sum from them, p normalised with those and rounded to the cache
  dtype, the partial PV sums added in rank order) against
  ``concat_attention_reference``: within 1e-5 * max|ref| in f32 and 2 bf16
  ulps in bf16 at every cluster size; duplicated rows come out bit-equal.
- The CUDA kernel runs only on the card (``cuda`` marker); here the wrapper's
  checks and its CPU routing are tested.
"""

import math
import os
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.ops.decode_attention import decode_attention as pallas_decode_attention  # noqa: E402
from s2s_tpu.parallel.batched_decode import _concat_attention  # noqa: E402
from s2s_tpu_torch.ops import decode_attention as tda  # noqa: E402


def _close(ref, got, rel=1e-5):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def _operands(b, h, kv, t, n, hd, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    cache_len = rng.integers(0, t + 1, b).astype(np.int32)
    cache_len[0] = t  # one row reads the whole cache
    tail_len = rng.integers(1, n + 1, b).astype(np.int32)
    return r(b, h, hd), r(b, kv, t, hd), r(b, kv, t, hd), r(b, kv, n, hd), r(b, kv, n, hd), cache_len, tail_len


@pytest.mark.parametrize("b,h,kv,t,n,hd", [(3, 4, 4, 24, 6, 64), (4, 4, 2, 16, 3, 128), (2, 8, 4, 12, 1, 16)])
def test_reference_matches_concat_attention(b, h, kv, t, n, hd):
    q, ck, cv, tk, tv, cl, tl = _operands(b, h, kv, t, n, hd)
    cache_mask = (np.arange(t)[None, :] < cl[:, None])[:, None, None, :]
    tail_mask = (np.arange(n)[None, :] < tl[:, None])[:, None, None, :]
    want = _concat_attention(jnp.asarray(q)[:, :, None, :], jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(tk),
                             jnp.asarray(tv), jnp.asarray(cache_mask), jnp.asarray(tail_mask),
                             SimpleNamespace(head_dim=hd))[:, :, 0, :]
    got = tda.concat_attention_reference(*(torch.from_numpy(x) for x in (q, ck, cv, tk, tv, cl, tl)))
    _close(want, got)
    # the wrapper routes CPU tensors to the plain version and never launches
    before = tda.concat_attention.launches
    routed = tda.concat_attention(*(torch.from_numpy(x) for x in (q, ck, cv, tk, tv, cl, tl)))
    assert torch.equal(routed, got) and tda.concat_attention.launches == before


def test_reference_rounds_p_to_the_cache_dtype_in_bf16():
    """In bf16, as in the JAX version, p is rounded before the PV product."""
    q, ck, cv, tk, tv, cl, tl = _operands(2, 4, 2, 20, 4, 64, seed=3)
    cache_mask = (np.arange(20)[None, :] < cl[:, None])[:, None, None, :]
    tail_mask = (np.arange(4)[None, :] < tl[:, None])[:, None, None, :]
    want = _concat_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q[:, :, None, :], ck, cv, tk, tv)),
                             jnp.asarray(cache_mask), jnp.asarray(tail_mask), SimpleNamespace(head_dim=64))
    got = tda.concat_attention_reference(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, ck, cv, tk, tv)),
                                         torch.from_numpy(cl), torch.from_numpy(tl))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want[:, :, 0, :], np.float32)
    ulp = 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * ulp)


@pytest.mark.parametrize("h,kv,hd", [(4, 2, 16), (8, 8, 64)])
def test_decode_attention_matches_pallas_interpret(h, kv, hd):
    b, t = 3, 16
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k_new, v_new = (rng.standard_normal((b, kv, 1, hd)).astype(np.float32) for _ in range(2))
    ck, cv = (rng.standard_normal((b, kv, t, hd)).astype(np.float32) for _ in range(2))
    pos = np.array([2, 9, t - 1], np.int32)
    want, want_k, want_v = pallas_decode_attention(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                                                   jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
                                                   interpret=True)
    tk_cache, tv_cache = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, got_k, got_v = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
                                             tk_cache, tv_cache, torch.from_numpy(pos))
    _close(want, got)
    assert got_k is tk_cache and got_v is tv_cache  # written in place
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_kernel_checks_reject_what_the_kernel_does_not_take():
    args = [torch.from_numpy(x) for x in _operands(2, 4, 2, 8, 2, 64)]
    bf = [a.to(torch.bfloat16) for a in args[:5]] + args[5:]
    tda._check(*bf)  # the supported case passes
    with pytest.raises(TypeError, match="one dtype"):
        tda._check(bf[0].float(), *bf[1:])
    with pytest.raises(TypeError, match="int32"):
        tda._check(*bf[:5], bf[5].long(), bf[6])
    with pytest.raises(ValueError, match="shape mismatch"):
        tda._check(bf[0], bf[1][:, :, :4].contiguous(), *bf[2:])
    with pytest.raises(ValueError, match="contiguous"):
        tda._check(bf[0], bf[1].transpose(2, 3).contiguous().transpose(2, 3), *bf[2:])
    with pytest.raises(ValueError, match="aligned"):
        tda._check(bf[0], torch.zeros(2 * 2 * 8 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 2, 8, 64), *bf[2:])
    with pytest.raises(ValueError, match="does not support"):  # hd = 48
        tda._check(torch.zeros(2, 4, 48, dtype=torch.bfloat16),
                   *(torch.zeros(2, 2, 8, 48, dtype=torch.bfloat16) for _ in range(2)),
                   *(torch.zeros(2, 2, 2, 48, dtype=torch.bfloat16) for _ in range(2)), *bf[5:])
    with pytest.raises(ValueError, match="does not support"):
        tda._check(torch.zeros(2, 18, 64, dtype=torch.bfloat16), *bf[1:])  # G = 9
    with pytest.raises(ValueError, match="device"):
        tda.concat_attention(*(a.to("meta") for a in bf))


@pytest.mark.parametrize("nk", [0, 1, 2, 7, 8, 9, 100, 518, 524])
@pytest.mark.parametrize("c", tda.CLUSTER_SIZES)
def test_split_ranges_cover_the_keys_in_rank_order(nk, c):
    ranges = tda.split_ranges(nk, c)
    assert len(ranges) == c
    assert ranges[0][0] == 0 and ranges[-1][1] == nk
    for (a0, z0), (a1, z1) in zip(ranges, ranges[1:]):
        assert a0 <= z0 == a1 <= z1  # disjoint, contiguous, in rank order
    chunk = -(-nk // c)
    assert all(z - a <= chunk for a, z in ranges)
    assert tda.split_ranges(nk, c) == ranges  # a function of (nk, c) alone


H100_SMS, H100_SMEM = 132, 232_448  # an H100's SMs and the shared memory a block may opt in to


def _cluster(b, kv, t, n, g, hd, esize, sms=H100_SMS):
    return tda.launch_plan(b, kv, t, n, g, hd, esize, sms, H100_SMEM).cluster


def test_cluster_size_fills_the_card_and_fits_shared_memory():
    # SmolLM2-1.7B (KV 32, hd 64, T 512 + 12): the grid reaches the SM count
    assert _cluster(1, 32, 512, 12, 1, 64, 2) == 8
    assert _cluster(4, 32, 512, 12, 1, 64, 2) == 2
    # 16 rows fill the card at 1, but 524 keys take 139 KB: 2 CTAs (70 KB each) share an SM
    assert _cluster(16, 32, 512, 12, 1, 64, 2) == 2
    assert _cluster(16, 32, 128, 12, 1, 64, 2) == 1
    # the Qwen3-TTS talker (KV 8, hd 128, G 2, T 192 + 4)
    assert _cluster(1, 8, 192, 4, 2, 128, 2) == 8
    assert _cluster(16, 8, 192, 4, 2, 128, 2) == 2
    # fewer SMs, fewer CTAs
    assert _cluster(1, 32, 512, 12, 1, 64, 2, sms=100) == 4
    assert _cluster(4, 32, 128, 12, 1, 64, 2, sms=100) == 1
    # the cluster grows until a CTA's keys fit: 2048 + 12 keys need C >= 4, and 8 to fit twice
    assert _cluster(16, 32, 2048, 12, 1, 64, 2) == 8
    plan = tda.launch_plan(32, 8, 2048, 4, 2, 128, 2, H100_SMS, H100_SMEM)  # filled at 1; fits at 8
    assert plan.cluster == 8 and plan.tile_rows == plan.rows_max == -(-2052 // 8) and plan.stages == 1
    assert plan.bytes <= H100_SMEM
    # keys that fit no cluster whole stream through a ring of tiles: the
    # talker at its max_seq_len 4096 (2 x 513 keys of 256 bytes at C 8) and
    # f32 at 2048 keys (2 x 257 of 512 bytes)
    for args in [(1, 8, 4096, 4, 2, 128, 2), (16, 8, 4096, 4, 2, 128, 2), (1, 8, 2048, 4, 2, 128, 4)]:
        plan = tda.launch_plan(*args, H100_SMS, H100_SMEM)
        assert plan.tile_rows == tda.TILE_ROWS < plan.rows_max and plan.bytes <= H100_SMEM // 2
    assert tda.launch_plan(1, 8, 4096, 4, 2, 128, 2, H100_SMS, H100_SMEM).stages == 2
    with pytest.raises(ValueError, match="do not fit"):  # only a cache far beyond any model's
        tda.launch_plan(1, 1, 1 << 20, 4, 8, 128, 4, H100_SMS, H100_SMEM)


def _assert_layout(plan, t, n, g, hd, esize):
    """The regions lie in order, 16-byte aligned, each holding what the kernel
    puts there (``plan_fits`` in ``csrc/decode_attention.cu``), and a CTA's
    keys fit its tiles."""
    ring = plan.stages * plan.tile_rows * hd * esize
    assert plan.cluster in tda.CLUSTER_SIZES and plan.rows_max * plan.cluster >= t + n
    assert plan.part >= 16 * plan.stages and plan.stat >= plan.part + 4 * g * hd
    assert plan.red >= plan.stat + 16 * tda.MAX_GROUP and plan.sc >= plan.red + 4 * 8 * g * hd
    assert plan.k >= plan.sc + 4 * g * (-(-plan.rows_max // 4) * 4)
    assert plan.v >= plan.k + ring and plan.bytes >= plan.v + ring
    assert all(x % 16 == 0 for x in (plan.part, plan.stat, plan.red, plan.sc, plan.k, plan.v))
    assert plan.tile_rows == plan.rows_max or plan.tile_rows == tda.TILE_ROWS


def _engine_models():
    from s2s_tpu_torch.models.decoder_lm import DecoderLMConfig
    from s2s_tpu_torch.models.qwen3_tts import Qwen3TTSConfig

    tts = Qwen3TTSConfig.qwen3_tts_12hz_1_7b()
    return {"smollm2-1.7b": DecoderLMConfig.smollm2_1_7b(), "smollm2-360m": DecoderLMConfig.smollm2_360m(),
            "qwen3-1.7b": DecoderLMConfig.qwen3_1_7b(), "qwen3-tts-talker": tts.lm,
            "qwen3-tts-code-predictor": tts.cp}


@pytest.mark.parametrize("model", sorted(_engine_models()))
def test_launch_plan_serves_every_cache_the_engines_accept(model):
    # the batched engines take any --*_batched_max_t up to the model's
    # max_seq_len, any slot count and chunk width: every such launch has a plan
    cfg = _engine_models()[model]
    g, hd = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    assert hd in tda.HEAD_DIMS and g <= tda.MAX_GROUP
    max_ts = sorted({min(1 << k, cfg.max_seq_len) for k in range(4, 16)} | {cfg.max_seq_len, cfg.max_seq_len - 1})
    for t in max_ts:
        for b in (1, 2, 3, 4, 8, 16, 17, 32, 64, 128):
            for n in (1, 6, 12, 64):
                for esize in (2, 4):
                    plan = tda.launch_plan(b, cfg.n_kv_heads, t, n, g, hd, esize, H100_SMS, H100_SMEM)
                    assert plan.bytes <= H100_SMEM
                    _assert_layout(plan, t, n, g, hd, esize)


def _cluster_model(q, ck, cv, tk, tv, cache_len, tail_len, c):
    """The kernel's algorithm in torch: each of c CTAs takes its range of a
    row's keys, its max m_r and sum l_r = sum exp(s - m_r); the global m, l
    fold those in rank order; p = exp(s - m) / l rounded to the cache dtype;
    each CTA's partial PV in f32, summed in rank order."""
    b, h, hd = q.shape
    kv = ck.shape[1]
    out = torch.zeros(b, h, hd)
    for row in range(b):
        cl, tl = int(cache_len[row]), int(tail_len[row])
        keys = torch.cat([ck[row, :, :cl], tk[row, :, :tl]], dim=1).float()
        vals = torch.cat([cv[row, :, :cl], tv[row, :, :tl]], dim=1).float()
        s = torch.einsum("kgd,ktd->kgt", q[row].reshape(kv, h // kv, hd).float(), keys) * hd ** -0.5
        ranges = [(a, z) for a, z in tda.split_ranges(cl + tl, c) if z > a]
        m = torch.full(s.shape[:2], float("-inf"))
        l = torch.zeros(s.shape[:2])
        for a, z in ranges:
            m_r = s[..., a:z].amax(-1)
            l_r = torch.exp(s[..., a:z] - m_r[..., None]).sum(-1)
            m_new = torch.maximum(m, m_r)
            l = l * torch.exp(m - m_new) + l_r * torch.exp(m_r - m_new)
            m = m_new
        p = (torch.exp(s - m[..., None]) / l[..., None]).to(cv.dtype).float()
        o = torch.zeros(kv, h // kv, hd)
        for a, z in ranges:
            o = o + torch.einsum("kgt,ktd->kgd", p[..., a:z], vals[:, a:z])
        out[row] = o.reshape(h, hd)
    return out.to(q.dtype)


@pytest.mark.parametrize("c", tda.CLUSTER_SIZES)
@pytest.mark.parametrize("b,h,kv,t,n,hd", [(4, 8, 8, 64, 6, 64), (3, 16, 8, 48, 3, 128)])
def test_cluster_combine_model_matches_the_reference(c, b, h, kv, t, n, hd):
    raw = _operands(b, h, kv, t, n, hd, seed=11 + c)
    args = [torch.from_numpy(x) for x in raw]
    _close(tda.concat_attention_reference(*args), _cluster_model(*args, c))
    bf = [a.to(torch.bfloat16) for a in args[:5]] + args[5:]
    want = tda.concat_attention_reference(*bf).float()
    got = _cluster_model(*bf, c)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert (got.float() - want).abs().max().item() <= 2 * ulp
    # rows duplicated as a padded width bucket: bit-equal outputs
    pair = torch.arange(b) % 2
    dup = _cluster_model(*(x[pair] for x in bf), c)
    assert all(torch.equal(dup[i], dup[i % 2]) for i in range(b))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,t,n,hd", [(1, 16, 8, 192, 3, 128), (4, 32, 32, 512, 6, 64),
                                          (16, 32, 32, 512, 12, 64), (1, 32, 32, 512, 1, 64),
                                          # keys streamed through a ring: the talker and Qwen3-1.7B at
                                          # their max_seq_len
                                          (1, 16, 8, 4096, 4, 128), (16, 16, 8, 4096, 4, 128),
                                          (1, 16, 8, 32768, 6, 128), (17, 16, 8, 32768, 6, 128)])
def test_cuda_kernel_matches_plain(cuda_device, b, h, kv, t, n, hd):
    args = [torch.from_numpy(x).to(cuda_device) for x in _operands(b, h, kv, t, n, hd)]
    bf = [a.to(torch.bfloat16) for a in args[:5]] + args[5:]
    before = tda.concat_attention.launches
    got = tda.concat_attention(*bf)
    want = tda.concat_attention_reference(*bf)
    torch.cuda.synchronize()
    assert tda.concat_attention.launches == before + 1
    ulp = 2.0 ** (math.floor(math.log2(want.float().abs().max().item())) - 7)
    assert (got.float() - want.float()).abs().max().item() <= 2 * ulp


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,t,n,hd", [(4, 32, 32, 512, 6, 64), (16, 16, 8, 192, 3, 128)])
def test_cuda_kernel_gives_duplicated_rows_equal_bits(cuda_device, b, h, kv, t, n, hd):
    args = [torch.from_numpy(x).to(cuda_device) for x in _operands(b, h, kv, t, n, hd, seed=7)]
    pair = torch.arange(b, device=cuda_device) % 2
    bf = [a[pair].to(torch.bfloat16).contiguous() for a in args[:5]] + [a[pair].contiguous() for a in args[5:]]
    got = tda.concat_attention(*bf)
    torch.cuda.synchronize()
    assert all(torch.equal(got[i], got[i % 2]) for i in range(b))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,t,n,hd", [(3, 16, 8, 192, 3, 128), (2, 16, 8, 2048, 4, 128)])
def test_cuda_kernel_matches_plain_in_f32(cuda_device, b, h, kv, t, n, hd):
    # f32 (the tiny parity programs' type); 2048 keys of 512 bytes stream through a ring
    args = [torch.from_numpy(x).to(cuda_device) for x in _operands(b, h, kv, t, n, hd, seed=3)]
    got = tda.concat_attention(*args)
    want = tda.concat_attention_reference(*args)
    torch.cuda.synchronize()
    _close(want.cpu(), got.cpu())
