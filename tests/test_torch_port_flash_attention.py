"""Parity: s2s_tpu_torch.ops.flash_attention against the JAX package.

- ``flash_attention_reference`` against the Pallas kernel
  ``s2s_tpu.ops.pallas_attention.flash_attention(interpret=True)`` at
  tile-aligned shapes, unmasked and causal, D 64 and 128: within 2e-5 in
  f32 (the JAX package's own bound for its kernel against XLA attention),
  and within 2 bf16 ulps of max|ref| with bf16 inputs (both keep p in f32;
  they differ by f32 sum order, then by one rounding to bf16).
- Against JAX ``models.common.attention(mask=None)`` (and with a causal
  mask) at the ragged Whisper and Smart Turn shapes, 50 and 400 positions,
  which the Pallas kernel cannot take: within 2e-5 in f32.
- The port's ``models.common.attention`` sends unmasked attention of >= 16
  queries with head dim 64 or 128 to ``flash_attention`` (the plain version
  on the CPU) and everything else to its plain path.
- The wrapper refuses what the kernel cannot take (dtype, shape, head dim,
  layout, the 16-byte alignment of its loads); the CUDA kernel runs only on
  the card (``cuda`` marker).
- An emulation of the bf16 tensor-core kernel's numerics (64-key tiles, an
  online max, p rounded to bf16 before PV, l summed from the f32 p) stays
  within ``chip_smoke.py``'s bound, 2 bf16 ulps of max|plain|, at its 10
  encoder shapes: the margin the kernel's rounding leaves, known before the
  card runs it.
"""

import math
import os
import re
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.models.common import attention as jax_attention  # noqa: E402
from s2s_tpu.models.common import causal_mask as jax_causal_mask  # noqa: E402
from s2s_tpu.ops.pallas_attention import flash_attention as pallas_flash  # noqa: E402
from s2s_tpu_torch.models import common  # noqa: E402
from s2s_tpu_torch.ops import flash_attention as fa  # noqa: E402


def _qkv(b, h, tq, tk, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d)))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.mark.parametrize("b,h,tq,tk,d,causal", [
    (1, 2, 256, 256, 64, False), (1, 2, 256, 256, 64, True), (1, 2, 128, 384, 128, False),
    (2, 1, 256, 256, 128, False), (2, 1, 256, 256, 128, True)])
def test_reference_matches_the_interpreted_pallas_kernel(b, h, tq, tk, d, causal):
    q, k, v = _qkv(b, h, tq, tk, d)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True))
    got = fa.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_reference_matches_the_interpreted_pallas_kernel_in_bf16():
    q, k, v = _qkv(1, 2, 256, 256, 64, seed=1)
    want = pallas_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), interpret=True)
    got = fa.flash_attention_reference(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * _bf16_ulp(float(np.abs(want).max())))


@pytest.mark.parametrize("h,t", [(4, 50), (6, 400)])
def test_reference_matches_jax_attention_at_ragged_encoder_shapes(h, t):
    q, k, v = _qkv(1, h, t, t, 64, seed=t)
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = fa.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    want_causal = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           mask=jax_causal_mask(t, t, 0)))
    got_causal = fa.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), causal=True).numpy()
    np.testing.assert_allclose(got_causal, want_causal, rtol=0, atol=2e-5)


def test_attention_routes_unmasked_encoder_shapes_to_flash(monkeypatch):
    calls = []
    real = fa.flash_attention_reference

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_reference", spy)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 50, 50, 64, seed=3))
    before = fa.flash_attention.launches
    routed = common.attention(q, k, v)
    assert calls == [q.shape] and fa.flash_attention.launches == before  # the plain version on the CPU
    want = np.asarray(jax_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v))))
    np.testing.assert_allclose(routed.numpy(), want, rtol=0, atol=2e-5)
    # GQA: kv heads are repeated before the route
    common.attention(q, k[:, :2], v[:, :2])
    assert len(calls) == 2
    # masked, short (decoder cross-attention) and other head dims stay plain
    common.attention(q, k, v, mask=torch.ones(1, 1, 50, 50, dtype=torch.bool))
    common.attention(q[:, :, :4], k, v)
    q16, k16, v16 = (torch.from_numpy(x) for x in _qkv(1, 4, 50, 50, 16))
    common.attention(q16, k16, v16)
    assert len(calls) == 2
    assert fa.use_flash_for(16, 64) and fa.use_flash_for(1500, 128)
    assert not fa.use_flash_for(15, 64) and not fa.use_flash_for(400, 32)


def test_kernel_checks_reject_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(1, 2, 50, 60, 64))
    fa._check(q, k, v)  # the supported case passes
    fa._check(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)  # strided heads are taken
    with pytest.raises(TypeError, match="one dtype"):
        fa._check(q.float(), k, v)
    with pytest.raises(ValueError, match="shape mismatch"):
        fa._check(q, k[:, :, :10], v)
    with pytest.raises(ValueError, match="does not support"):
        fa._check(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="contiguous"):
        fa._check(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check(torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape), k, v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check(q, torch.zeros(1, 2, 60, 68, dtype=k.dtype)[..., 2:66], v)
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention(*(x.to("meta") for x in (q, k, v)))


#: the tensor-core kernel's keys per tile, read from its source (``kBN``)
_KEY_TILE = int(re.search(r"constexpr int kBN = (\d+);", (Path(fa.__file__).parents[1] / "csrc" /
                                                          "flash_attention.cu").read_text()).group(1))


def _kernel_emulation(q, k, v, causal):
    """The bf16 kernel's arithmetic in f32 torch: per key tile, raw
    scores of the bf16 inputs, the new row max, p = 2^(s * scale * log2 e -
    m * scale * log2 e), l from the f32 p, the output rescaled and p
    rounded to bf16 before PV; one division at the end, then bf16."""
    qf, kf, vf = q.float(), k.float(), v.float()
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    sl2 = d ** -0.5 * math.log2(math.e)
    m = torch.full(q.shape[:3], float("-inf"))
    l = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    rows = torch.arange(tq)[:, None]
    for k0 in range(0, tk, _KEY_TILE):
        s = qf @ kf[:, :, k0:k0 + _KEY_TILE].transpose(-1, -2)
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + s.shape[-1])[None, :] > rows, float("-inf"))
        mx = torch.maximum(m, s.amax(-1))
        mu = torch.where(mx == float("-inf"), torch.zeros_like(mx), mx * sl2)
        corr = torch.exp2(m * sl2 - mu)
        p = torch.exp2(s * sl2 - mu[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + _KEY_TILE]
        m = mx
    return (o / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


#: chip_smoke.py's FLASH_SHAPES: (heads, positions, causal), head dim 64
_CHIP_FLASH_SHAPES = [(20, t, False) for t in (50, 100, 150, 250, 400, 600, 750, 1500)] + [(6, 400, False),
                                                                                         (20, 1500, True)]


@pytest.mark.parametrize("h,t,causal", _CHIP_FLASH_SHAPES)
def test_bf16_kernel_rounding_stays_within_the_chip_bound(h, t, causal):
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(1, h, t, t, 64, seed=t + causal))
    got = _kernel_emulation(q, k, v, causal).float()
    err, bound = 0.0, 0.0
    for h0 in range(0, h, 4):  # the plain version a few heads at a time: T x T scores per head
        want = fa.flash_attention_reference(q[:, h0:h0 + 4], k[:, h0:h0 + 4], v[:, h0:h0 + 4], causal=causal).float()
        err = max(err, (got[:, h0:h0 + 4] - want).abs().max().item())
        bound = max(bound, want.abs().max().item())
    assert err <= 2 * _bf16_ulp(bound), (err, 2 * _bf16_ulp(bound))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,tq,tk,d,causal", [(20, 50, 50, 64, False), (6, 400, 400, 64, False),
                                              (4, 130, 200, 128, False), (2, 256, 256, 64, True),
                                              (20, 1500, 1500, 64, False), (20, 1500, 1500, 64, True),
                                              (6, 333, 400, 128, False), (3, 77, 77, 128, True)])
def test_cuda_kernel_matches_plain(cuda_device, h, tq, tk, d, causal):
    q, k, v = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in _qkv(1, h, tq, tk, d))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= 2 * _bf16_ulp(want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_kernel_gives_a_duplicated_head_equal_bits(cuda_device, d):
    q, k, v = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in _qkv(1, 6, 400, 400, d, seed=2))
    got = fa.flash_attention(*(torch.cat([x, x[:, :1]], dim=1) for x in (q, k, v)))
    torch.cuda.synchronize()
    assert torch.equal(got[:, 6], got[:, 0])
