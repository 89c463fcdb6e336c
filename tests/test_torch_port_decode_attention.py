"""Parity: s2s_tpu_torch.ops.decode_attention against the JAX package.

- ``concat_attention_reference`` against ``batched_decode._concat_attention``
  (the serving programs' attention): within 1e-5 * max|ref| in f32, GQA
  groups of 1 and 2, lengths from a seed with one row at the full cache.
- The port's ``decode_attention`` (plain, CPU) against the Pallas kernel
  ``s2s_tpu.ops.decode_attention.decode_attention`` in interpret mode, as
  ``tests/test_batched_decode.py`` runs it: output within 1e-5 * max|ref|,
  caches equal after the in-place slot write.
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,t,n,hd", [(1, 16, 8, 192, 3, 128), (4, 32, 32, 512, 6, 64)])
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
