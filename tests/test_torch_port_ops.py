"""Parity: s2s_tpu_torch.ops (int8 quantization and the W8A16 matmul)
against the JAX package's ``ops.quant`` and ``ops.int8_matmul``.

- ``quantize_tree``: int8 ``q`` equal everywhere, ``scale`` within 1 f32 ulp.
- The plain int8 matmul against the Pallas kernel run in interpret mode, in
  bf16: within 2 bf16 ulps of max|ref| (the sums run in another order); and
  against JAX's einsum path in f32: within 1e-5 * max|ref|.
- The CUDA kernel itself runs only on the card (``cuda`` marker); here the
  wrapper's checks, routing and split choice are tested.
"""

import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.ops import int8_matmul as jmm  # noqa: E402
from s2s_tpu.ops import quant as jquant  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import common, qwen3_tts  # noqa: E402
from s2s_tpu_torch.ops import int8_matmul as tmm  # noqa: E402
from s2s_tpu_torch.ops import quant as tquant  # noqa: E402


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _tree():
    rng = np.random.default_rng(0)
    return {
        "embed": rng.standard_normal((300, 256)).astype(np.float32),
        "layers": {
            "wq": rng.standard_normal((3, 256, 384)).astype(np.float32),
            "attn_norm": rng.standard_normal((3, 256)).astype(np.float32),
        },
        "head": rng.standard_normal((256, 512)).astype(np.float32) * 1e-3,
        "small": rng.standard_normal((16, 16)).astype(np.float32),
        "ids": np.arange(70000, dtype=np.int32).reshape(700, 100),
        "blocks": [{"w": rng.standard_normal((512, 128)).astype(np.float32)}],
    }


def test_quantize_tree_matches_jax_bit_for_bit():
    tree = _tree()
    jt = jquant.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree), min_size=4096)
    tt = tquant.quantize_tree(weights.tree_to_torch(tree, "cpu"), min_size=4096)
    for path in (("layers", "wq"), ("head",), ("blocks", 0, "w")):
        jl, tl = jt, tt
        for key in path:
            jl, tl = jl[key], tl[key]
        assert isinstance(tl, tquant.QuantWeight), path
        np.testing.assert_array_equal(np.asarray(jl.q), tl.q.numpy())
        js = np.asarray(jl.scale)
        assert js.shape == tuple(tl.scale.shape)
        np.testing.assert_array_max_ulp(js, tl.scale.numpy(), maxulp=1)
    # skip rules: name (embed/norm), size, dtype
    for key in ("embed", "small", "ids"):
        assert not isinstance(tt[key], tquant.QuantWeight)
    assert not isinstance(tt["layers"]["attn_norm"], tquant.QuantWeight)


def test_quantize_tree_bridges_jax_quant_weights():
    """A JAX-quantized tree crosses the bridge with q/scale unchanged."""
    jt = jquant.quantize_tree(jax.tree_util.tree_map(jnp.asarray, _tree()), min_size=4096)
    tt = weights.tree_to_torch(jt, "cpu")
    assert isinstance(tt["head"], tquant.QuantWeight)
    np.testing.assert_array_equal(np.asarray(jt["head"].q), tt["head"].q.numpy())


@pytest.mark.parametrize("mode", ["int8-dyn", "int4", "int8+cp4"])
def test_unported_quant_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tquant.check_mode(mode)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        qwen3_tts.Qwen3TTS(cfg=qwen3_tts.Qwen3TTSConfig.tiny(), int8=mode)
    tquant.check_mode("int8")
    tquant.check_mode(None)
    with pytest.raises(ValueError, match="unknown"):
        tquant.check_mode("int3")


def _operands(b, k, n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, k)).astype(np.float32)
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.random(n) * 0.01 + 1e-4).astype(np.float32)
    return x, q, s


@pytest.mark.parametrize("b,k,n", [(1, 256, 128), (2, 128, 384), (17, 256, 256), (64, 384, 128)])
def test_plain_matches_pallas_interpret_bf16(b, k, n):
    x, q, s = _operands(b, k, n)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jmm.int8_matmul(xb, jnp.asarray(q), jnp.asarray(s), interpret=True), np.float32)
    got = tmm.int8_matmul(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q),
                          torch.from_numpy(s))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, n)
    bound = 2 * _bf16_ulp(float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=bound)


@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_quantized_linear_matches_jax_einsum_f32(lead):
    x, q, s = _operands(int(np.prod(lead)), 256, 384, seed=2)
    x = x.reshape(*lead, 256)
    b = np.random.default_rng(3).standard_normal(384).astype(np.float32)
    want = np.asarray(jquant.quantized_linear(jnp.asarray(x), jquant.QuantWeight(jnp.asarray(q), jnp.asarray(s)),
                                              jnp.asarray(b)))
    got = common.linear(torch.from_numpy(x), tquant.QuantWeight(torch.from_numpy(q), torch.from_numpy(s)),
                        torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def test_kernel_checks_reject_what_supports_rejects():
    x, q, s = (torch.from_numpy(a) for a in _operands(2, 256, 128))
    xb = x.to(torch.bfloat16)
    tmm._check(xb, q, s)  # the supported case passes
    with pytest.raises(TypeError):
        tmm._check(x, q, s)  # f32 activations
    with pytest.raises(ValueError, match="shape"):
        tmm._check(xb[:, :128].contiguous(), q, s)
    with pytest.raises(ValueError, match="contiguous"):
        tmm._check(xb, torch.from_numpy(np.asfortranarray(q.numpy())), s)
    with pytest.raises(ValueError, match="does not support"):
        tmm._check(xb[:1, :200].contiguous(), q[:200].contiguous(), s)
    with pytest.raises(ValueError, match="does not support"):
        tmm._check(torch.zeros(65, 256, dtype=torch.bfloat16), q, s)
    with pytest.raises(ValueError, match="device"):
        tmm.int8_matmul(xb.to("meta"), q.to("meta"), s.to("meta"))


def test_supports_is_the_jax_contract():
    for b, k, n in [(1, 2048, 2048), (64, 8192, 2048), (65, 128, 128), (1, 100, 128),
                    (1, 128, 100), (1, 32768, 256), (1, 16384, 256)]:
        assert tmm.supports(b, k, n) == jmm.supports(b, k, n), (b, k, n)


def test_split_count_fills_the_card_and_divides_k():
    for b, k, n in [(1, 2048, 2048), (2, 2048, 6144), (17, 8192, 2048), (64, 2048, 8192),
                    (1, 6144, 2048), (64, 128, 128)]:
        splits = tmm.split_count(b, k, n, 132)
        assert splits >= 1 and k % (splits * 64) == 0 or splits == 1
        assert (k // splits) % 8 == 0


def test_cpu_tensors_never_launch():
    before = tmm.int8_matmul.launches
    x, q, s = (torch.from_numpy(a) for a in _operands(1, 256, 128))
    tmm.int8_matmul(x.to(torch.bfloat16), q, s)
    common.linear(x.to(torch.bfloat16), tquant.QuantWeight(q, s))
    assert tmm.int8_matmul.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 17, 64])
def test_cuda_kernel_matches_plain(cuda_device, b):
    x, q, s = (torch.from_numpy(a).to(cuda_device) for a in _operands(b, 2048, 1024))
    xb = x.to(torch.bfloat16)
    before = tmm.int8_matmul.launches
    got = tmm.int8_matmul(xb, q, s)
    want = tmm.int8_matmul_reference(xb, q, s)
    torch.cuda.synchronize()
    assert tmm.int8_matmul.launches == before + 1
    bound = 2 * _bf16_ulp(want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= bound
