"""The weight-only matmul kernels' design, on the CPU: the launch plan and a
torch model of the kernels' sum order (``s2s_tpu_torch/ops/weight_only.py``,
``csrc/weight_only_matmul.cuh``, behind ``int8_matmul`` and ``int4_matmul``).

- ``launch_plan`` at every (B 1-64, K, N) that SmolLM2-1.7B, the Qwen3-TTS
  talker and its code predictor send to the kernels, in both formats, with
  an H100's cluster occupancy: one wave that fills the card as far as its
  clusters allow, one CTA an SM within a block's shared memory, K covered
  exactly in rank order, the regime switching at the cutoff.
- The kernels' sum order, modelled in torch f32 (regime 0 exactly as the
  kernel adds: each thread's rows in order, the shuffle tree, the warps,
  the cluster ranks; regime 1 by 16-row product steps, tiles, the two
  warpgroups' sums and ranks),
  within 2 bf16 ulps of max|plain| at the served shapes and of the JAX
  package's Pallas kernels run in interpret mode.
- The build digest covers the shared headers.
- On the card (``cuda`` marker; skipped here): duplicated rows bit-equal and
  two calls on one input bit-equal, both formats, rows 1-64.
"""

import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.ops import int4_matmul as jmm4  # noqa: E402
from s2s_tpu.ops import int8_matmul as jmm  # noqa: E402
from s2s_tpu_torch.models.decoder_lm import DecoderLMConfig  # noqa: E402
from s2s_tpu_torch.models.qwen3_tts import Qwen3TTSConfig  # noqa: E402
from s2s_tpu_torch.ops import _build, weight_only  # noqa: E402
from s2s_tpu_torch.ops import int4_matmul as tmm4  # noqa: E402
from s2s_tpu_torch.ops import int8_matmul as tmm  # noqa: E402

SMS, SMEM = 132, 232448  # an H100 SXM: SMs, shared bytes a block may opt in to
#: clusters of C CTAs of one per SM that an H100 SXM runs at once
#: (cudaOccupancyMaxActiveClusters on the card, through device_limits)
CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
PLANES = {"int8": 1, "int4": 2}


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _linear_shapes(cfg: DecoderLMConfig) -> set[tuple[int, int]]:
    """(K, N) of a decoder's quantized linears: q, k, v, o, gate, up, down."""
    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {(d, hq), (d, hkv), (hq, d), (d, cfg.d_ff), (cfg.d_ff, d)}


TTS = Qwen3TTSConfig.qwen3_tts_12hz_1_7b()
MODELS = {"smollm2-1.7b": _linear_shapes(DecoderLMConfig.smollm2_1_7b()),
          "qwen3-tts-talker": _linear_shapes(TTS.lm), "qwen3-tts-code-predictor": _linear_shapes(TTS.cp)}


def _one_wave_grids(b, k, n, planes):
    """Every grid the plan could choose for the regime of b rows that the
    card runs in one wave."""
    tiles = weight_only.TILES_N[weight_only.REGIMES[int(b >= weight_only.CUTOFF[planes])]]
    return [n // tn * c for tn in tiles if n % tn == 0 for c in weight_only.CLUSTER_SIZES
            if c <= k // planes // weight_only.TILE_K and n // tn * c <= CLUSTERS[c] * c]


@pytest.mark.parametrize("fmt", sorted(PLANES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_launch_plan_at_every_served_shape(model, fmt):
    planes = PLANES[fmt]
    supports = tmm.supports if fmt == "int8" else tmm4.supports
    for k, n in sorted(MODELS[model]):
        for b in range(1, 65):
            assert supports(b, k, n), (b, k, n)
            plan = weight_only.launch_plan(b, k, n, SMS, SMEM, planes, clusters=CLUSTERS)
            where = (model, fmt, b, k, n, plan)
            # the regime switches at the cutoff; a CUDA-core row tile holds the rows
            assert plan.regime == int(b >= weight_only.CUTOFF[planes]), where
            assert plan.rows >= b and (plan.rows in weight_only.ROW_TILES if plan.regime == 0 else plan.rows % 8 == 0)
            # one wave that fills the card as far as its clusters allow: the
            # largest grid the card runs at once, one CTA an SM, at least half
            grid = plan.grid(n)
            assert grid == max(_one_wave_grids(b, k, n, planes)) and SMS // 2 - 2 <= grid <= SMS, where
            # within a block's shared memory, as the kernel lays it out, and
            # more than half of it (one CTA an SM)
            kc = weight_only.tile_rows(k // planes, plan.cluster)
            need = weight_only.shared_bytes(plan.regime, plan.tile_n, plan.rows, planes, kc, plan.stages, plan.cluster)
            assert plan.bytes == max(need, weight_only.one_per_sm(SMEM)) <= SMEM < 2 * plan.bytes, where
            tiles = kc // weight_only.TILE_K
            assert min(tiles, 2 if plan.regime else 1) <= plan.stages <= tiles, where
            # K covered exactly, in rank order, in whole stages
            ranges = weight_only.split_ranges(k, planes, plan.cluster)
            assert ranges[0][0] == 0 and ranges[-1][1] == k // planes, where
            assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:])), where
            assert all((z - a) % weight_only.TILE_K == 0 and 0 < z - a <= kc for a, z in ranges), where


@pytest.mark.parametrize("fmt", sorted(PLANES))
def test_launch_plan_takes_every_supported_extreme(fmt):
    """The largest K that ``supports`` admits at the narrowest N, and the
    smallest shapes, plan in both regimes within the shared memory."""
    planes = PLANES[fmt]
    supports = tmm.supports if fmt == "int8" else tmm4.supports
    step = 128 * planes
    for n in (128, 256, 49152):
        kmax = max(k for k in range(step, (1 << 17) + 1, step) if supports(1, k, n))
        for k in (step, 3 * step, kmax):
            for b in (1, 7, 8, 64):
                plan = weight_only.launch_plan(b, k, n, SMS, SMEM, planes)
                assert plan.bytes <= SMEM and plan.regime == int(b >= weight_only.CUTOFF[planes]), (b, k, n, plan)


def test_launch_plan_forced_regime_and_what_it_refuses():
    assert weight_only.launch_plan(8, 2048, 2048, SMS, SMEM, regime=0).regime == 0
    assert weight_only.launch_plan(4, 2048, 2048, SMS, SMEM, regime=1).regime == 1
    with pytest.raises(ValueError, match="at most"):
        weight_only.launch_plan(9, 2048, 2048, SMS, SMEM, regime=0)
    with pytest.raises(ValueError, match="shared bytes"):
        weight_only.launch_plan(1, 2048, 2048, SMS, 4096)
    # the default occupancy, SMS // C clusters, and a card that holds fewer
    assert weight_only.launch_plan(1, 2048, 2048, SMS, SMEM).grid(2048) == 128
    assert weight_only.launch_plan(1, 2048, 2048, SMS, SMEM, clusters=CLUSTERS).grid(2048) == 96
    with pytest.raises(ValueError, match="no plan"):
        weight_only.launch_plan(65, 2048, 2048, SMS, SMEM)


# --- a torch model of the kernels' sum order --------------------------------

def _planes_of(w: torch.Tensor, planes: int) -> torch.Tensor:
    """(planes, K / planes, N) f32 weight rows as the kernel unpacks them."""
    if planes == 1:
        return w.float()[None]
    lo, hi = tmm4.unpack_nibbles(w)
    return torch.stack([lo, hi]).float()


def kernel_model(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, planes: int,
                 plan: weight_only.Plan) -> torch.Tensor:
    """The kernel's sums in f32, on the CPU.  Regime 0 adds as the kernel
    does: each consumer thread's products (exact in f32) in the order it
    reads its rows (tile, pass, plane), the warp's lanes that share columns
    by an xor tree, the 8 warps in order, the cluster's ranks in order.
    Regime 1: 16-row steps of bf16 products (exact) summed in f32 (the
    tensor cores' order within a step is the hardware's), the planes, steps
    and tiles in order into the sum of the warpgroup that takes the tile
    (tiles alternate between two), then the ranks' two sums each, in order.
    Then the scale once, one rounding."""
    b = x.shape[0]
    wp = _planes_of(w, planes)
    kr, n = wp.shape[1], wp.shape[2]
    xp = x.float().reshape(b, planes, kr)
    tk = weight_only.TILE_K
    parts = []
    for start, stop in weight_only.split_ranges(kr * planes, planes, plan.cluster):
        tiles = (stop - start) // tk
        xr, wr = xp[:, :, start:stop], wp[:, start:stop]
        if plan.regime == 0:
            lpr = plan.tile_n // 16
            rpp = 32 * 8 // lpr  # rows a pass of the 256 consumers reads
            rpw = 32 // lpr      # row groups per warp
            passes = tk // rpp
            acc = torch.zeros(b, 8, rpw, n)
            for t in range(tiles):
                for ps in range(passes):
                    j = t * tk + ps * rpp + torch.arange(rpp)
                    for p in range(planes):
                        prod = xr[:, p, j][:, :, None] * wr[p, j][None]  # (b, rpp, n)
                        acc = acc + prod.reshape(b, 8, rpw, n)
            off = 1
            while off < rpw:  # the shuffle tree: row group g adds g ^ off
                acc = acc + acc[:, :, torch.arange(rpw) ^ off]
                off *= 2
            part = torch.zeros(b, n)
            for warp in range(8):
                part = part + acc[:, warp, 0]
            parts.append(part)
        else:
            groups = [torch.zeros(b, n) for _ in range(weight_only.TC_GROUPS)]
            for t in range(tiles):  # warpgroup t % 2 takes tile t
                for p in range(planes):
                    for kk in range(tk // 16):
                        j = slice(t * tk + 16 * kk, t * tk + 16 * kk + 16)
                        groups[t % 2] = groups[t % 2] + xr[:, p, j] @ wr[p, j]
            parts.extend(groups)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return (total * scale.float()).to(torch.bfloat16)


def _operands(b, k, n, planes, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32)).to(torch.bfloat16)
    lo = -128 if planes == 2 else -127
    w = torch.from_numpy(rng.integers(lo, 128, (k // planes, n)).astype(np.int8))
    s = torch.from_numpy((rng.random(n) * 0.01 + 1e-4).astype(np.float32))
    if b > 1:
        x[-1] = x[0]
    return x, w, s


def _plain(x, w, s, planes):
    return (tmm.int8_matmul_reference if planes == 1 else tmm4.int4_matmul_reference)(x, w, s)


@pytest.mark.parametrize("fmt", sorted(PLANES))
@pytest.mark.parametrize("b,k,n", [(1, 2048, 6144), (4, 2048, 2048), (7, 8192, 2048), (8, 2048, 1024),
                                   (16, 6144, 2048), (32, 2048, 8192), (64, 2048, 2048)])
def test_kernel_sum_order_within_two_ulps_of_plain(fmt, b, k, n):
    """At the served shapes (a 512-column slice of each; the columns do not
    change the order), both the kernel's plan and the other regime stay
    within 2 bf16 ulps of max|plain|, and a duplicated row comes out
    bit-equal."""
    planes = PLANES[fmt]
    x, w, s = _operands(b, k, n, planes, seed=b + k)
    w, s = w[:, :512].contiguous(), s[:512].contiguous()
    want = _plain(x, w, s, planes).float()
    tol = 2 * _bf16_ulp(want.abs().max().item())
    plan = weight_only.launch_plan(b, k, n, SMS, SMEM, planes)
    regimes = [plan, weight_only.launch_plan(b, k, n, SMS, SMEM, planes, regime=1 - plan.regime)] \
        if b <= weight_only.ROW_TILES[-1] else [plan]
    for p in regimes:
        got = kernel_model(x, w, s, planes, p)
        assert (got.float() - want).abs().max().item() <= tol, (p, tol)
        assert torch.equal(got[-1], got[0])


@pytest.mark.parametrize("fmt", sorted(PLANES))
@pytest.mark.parametrize("b", [2, 8, 17])
def test_kernel_sum_order_matches_pallas_interpret(fmt, b):
    """The model of both regimes against the JAX package's Pallas kernel run
    in interpret mode, in bf16: within 2 bf16 ulps of max|JAX|."""
    planes = PLANES[fmt]
    k, n = 1024, 256
    x, w, s = _operands(b, k, n, planes, seed=b)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    kern = jmm.int8_matmul if planes == 1 else jmm4.int4_matmul
    want = np.asarray(kern(xj, jnp.asarray(w.numpy()), jnp.asarray(s.numpy()), interpret=True), np.float32)
    tol = 2 * _bf16_ulp(float(np.abs(want).max()))
    for regime in ((0, 1) if b <= weight_only.ROW_TILES[-1] else (1,)):
        plan = weight_only.launch_plan(b, k, n, SMS, SMEM, planes, regime=regime)
        got = kernel_model(x, w, s, planes, plan).float().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=str(plan))


def test_library_name_covers_the_shared_headers(tmp_path, monkeypatch):
    """A changed ``csrc/*.cuh`` (or ``*.cu``) changes the library's path, so
    a stale build is never loaded."""
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._library_path()
    assert _build._library_path() == first
    header.write_text("// two\n")
    second = _build._library_path()
    assert second != first
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build._library_path() not in (first, second)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", sorted(PLANES))
def test_cuda_duplicated_rows_and_repeated_calls_are_bit_equal(cuda_device, fmt):
    planes = PLANES[fmt]
    wrapper = tmm.int8_matmul if planes == 1 else tmm4.int4_matmul
    for b in (2, 4, 8, 16, 17, 32, 64):
        x, w, s = (t.to(cuda_device) for t in _operands(b, 2048, 1024, planes, seed=b))
        before = wrapper.launches
        got = wrapper(x, w, s)
        again = wrapper(x, w, s)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2
        assert torch.equal(got[-1], got[0]) and torch.equal(got, again), b
        want = _plain(x, w, s, planes).float()
        assert (got.float() - want).abs().max().item() <= 2 * _bf16_ulp(want.abs().max().item()), b
