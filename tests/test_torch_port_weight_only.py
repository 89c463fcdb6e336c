"""The int8 and int4 matmul kernels' design, on the CPU: the launch plan and
torch models of the kernels' sum order (``s2s_tpu_torch/ops/weight_only.py``,
``csrc/weight_only_matmul.cuh`` behind ``int8_matmul`` and ``int4_matmul``,
``csrc/int8_matmul_dyn.cu`` behind ``int8_matmul_dyn``).

- ``launch_plan`` at every (B, K, N) that SmolLM2-1.7B, the Qwen3-TTS
  talker and its code predictor send to the kernels, in the three formats
  (W8A16 and int4 at 1-64 rows, W8A8 at 8-64), with an H100's cluster
  occupancy: one wave that fills the card as far as its clusters allow, one
  CTA an SM within a block's shared memory, K covered exactly in rank
  order, the weight-only regime switching at the cutoff, W8A8 rows rounded
  up to an s8 ``wgmma`` N.
- The kernels' sum order, modelled in torch f32 (regime 0 exactly as the
  kernel adds: each thread's rows in order, the shuffle tree, the warps,
  the cluster ranks; regime 1 by 16-row product steps, tiles, the two
  warpgroups' sums and ranks),
  within 2 bf16 ulps of max|plain| at the served shapes and of the JAX
  package's Pallas kernels run in interpret mode.
- The W8A8 kernel's arithmetic, modelled in torch integers: the cluster's K
  slices, the cluster absmax over the CTAs' partial maxima, the quantize
  through each row's table of significand quotients, the swap-AB tile with
  zeroed padding rows, k32 products summed per warpgroup, the int32
  partials combined in rank order; bit-equal to the plain version and to
  the JAX package's ``int8_matmul_dyn_reference`` at B 8, 17 and 64, at the
  planned cluster size and others; given the rows' absmax over a wider K
  (``row_amax``, a row-parallel shard's), bit-equal to the plain version
  with the same maxima at one rank's shapes of two.  The table quantize
  equals IEEE division and round-half-even at every finite bf16 value.  The
  C entry point's K limit keeps the int32 sums exact and covers every K
  that ``supports`` admits.
- The build digest covers the shared headers and the toolkit's version.
- On the card (``cuda`` marker; skipped here): duplicated rows bit-equal and
  two calls on one input bit-equal, both weight-only formats, rows 1-64; the
  W8A8 entry point refuses a K past the int32 range.
"""

import ctypes
import dataclasses
import math
import os
import re

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
#: the plan tests' formats: (weight planes, forced regime, rows)
FORMATS = {"int8": (1, None, range(1, 65)), "int4": (2, None, range(1, 65)),
           "w8a8": (1, weight_only.W8A8, range(8, 65))}


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _linear_shapes(cfg: DecoderLMConfig) -> set[tuple[int, int]]:
    """(K, N) of a decoder's quantized linears: q, k, v, o, gate, up, down."""
    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {(d, hq), (d, hkv), (hq, d), (d, cfg.d_ff), (cfg.d_ff, d)}


TTS = Qwen3TTSConfig.qwen3_tts_12hz_1_7b()
MODELS = {"smollm2-1.7b": _linear_shapes(DecoderLMConfig.smollm2_1_7b()),
          "qwen3-tts-talker": _linear_shapes(TTS.lm), "qwen3-tts-code-predictor": _linear_shapes(TTS.cp)}


def _regime(b, planes, forced):
    return forced if forced is not None else int(b >= weight_only.CUTOFF[planes])


def _one_wave_grids(b, k, n, planes, regime):
    """Every grid the plan could choose for *regime* that the card runs in
    one wave."""
    tiles = weight_only.TILES_N[weight_only.REGIMES[regime]]
    return [n // tn * c for tn in tiles if n % tn == 0 for c in weight_only.CLUSTER_SIZES
            if c <= k // planes // weight_only.TILES_K[regime] and n // tn * c <= CLUSTERS[c] * c]


def _plan_rows_ok(plan, b):
    if plan.regime == 0:
        return plan.rows in weight_only.ROW_TILES
    if plan.regime == 1:
        return plan.rows % 8 == 0
    return plan.rows == min(r for r in weight_only.W8A8_ROWS if r >= b)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_launch_plan_at_every_served_shape(model, fmt):
    planes, forced, row_counts = FORMATS[fmt]
    supports = tmm4.supports if fmt == "int4" else tmm.supports
    for k, n in sorted(MODELS[model]):
        for b in row_counts:
            assert supports(b, k, n), (b, k, n)
            plan = weight_only.launch_plan(b, k, n, SMS, SMEM, planes, forced, clusters=CLUSTERS)
            where = (model, fmt, b, k, n, plan)
            # the weight-only regime switches at the cutoff; the rows hold B
            # (a CUDA-core row tile; 8-row steps; the least s8 wgmma N)
            regime = _regime(b, planes, forced)
            assert plan.regime == regime and plan.rows >= b and _plan_rows_ok(plan, b), where
            # one wave that fills the card as far as its clusters allow: the
            # largest grid the card runs at once, one CTA an SM, at least half
            grid = plan.grid(n)
            assert grid == max(_one_wave_grids(b, k, n, planes, regime)) and SMS // 2 - 2 <= grid <= SMS, where
            # within a block's shared memory, as the kernel lays it out, and
            # more than half of it (one CTA an SM)
            tk = weight_only.TILES_K[regime]
            kc = weight_only.tile_rows(k // planes, plan.cluster, tk)
            need = weight_only.shared_bytes(plan.regime, plan.tile_n, plan.rows, planes, kc, plan.stages, plan.cluster)
            assert plan.bytes == max(need, weight_only.one_per_sm(SMEM)) <= SMEM < 2 * plan.bytes, where
            tiles = kc // tk
            assert min(tiles, 2 if plan.regime else 1) <= plan.stages <= tiles, where
            # K covered exactly, in rank order, in whole stages
            ranges = weight_only.split_ranges(k, planes, plan.cluster, tk)
            assert ranges[0][0] == 0 and ranges[-1][1] == k // planes, where
            assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:])), where
            assert all((z - a) % tk == 0 and 0 < z - a <= kc for a, z in ranges), where


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_launch_plan_takes_every_supported_extreme(fmt):
    """The largest K that ``supports`` admits at the narrowest N, and the
    smallest shapes, plan in every regime within the shared memory."""
    planes, forced, _ = FORMATS[fmt]
    supports = tmm4.supports if fmt == "int4" else tmm.supports
    step = 128 * planes
    for n in (128, 256, 49152):
        kmax = max(k for k in range(step, (1 << 17) + 1, step) if supports(1, k, n))
        for k in (step, 3 * step, kmax):
            for b in (1, 7, 8, 64):
                plan = weight_only.launch_plan(b, k, n, SMS, SMEM, planes, forced)
                assert plan.bytes <= SMEM and plan.regime == _regime(b, planes, forced), (b, k, n, plan)


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
    with pytest.raises(ValueError, match="int8 weights"):
        weight_only.launch_plan(8, 2048, 2048, SMS, SMEM, planes=2, regime=weight_only.W8A8)


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


# --- a torch model of the W8A8 kernel's arithmetic ----------------------------

def table_quantize(x: torch.Tensor, xscale: torch.Tensor) -> torch.Tensor:
    """The kernel's quantize of bf16 rows x by their scales: each row's
    table of the IEEE quotients fl((1 + f / 128) / s) of the 128 bf16
    significands, the element's entry times its exact power of two, the
    sign, round half to even, clip to +-127 (``quantize`` in the kernel)."""
    fb = x.float().view(torch.int32)
    sig = (torch.arange(128, dtype=torch.int32) << 16 | 0x3F800000).view(torch.float32)
    tab = sig[None, :] / xscale[:, None].expand(-1, 128)
    v = (fb & 0x7F800000).view(torch.float32) * torch.gather(tab, 1, ((fb >> 16) & 0x7F).long())
    v = (v.view(torch.int32) ^ (fb & -(2**31))).view(torch.float32)
    return torch.clamp(torch.round(v), -127, 127)


def w8a8_kernel_model(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      plan: weight_only.Plan, row_amax: torch.Tensor | None = None) -> torch.Tensor:
    """The W8A8 kernel (``csrc/int8_matmul_dyn.cu``) on the CPU, in its
    order.  Each CTA of the cluster takes the maximum of |x| over its K
    slice; every CTA takes the maximum of the C slots and divides it by 127
    (IEEE), then quantizes through the rows' tables (:func:`table_quantize`).
    The swap-AB B tile holds xq for the rows of x padded with zero rows to
    the plan's s8 ``wgmma`` N (TMA's zero fill; scale 1, so they quantize
    to 0).  Each CTA sums q^T xq^T in k32 products into the sums of
    the warpgroup that takes the tile (tiles alternate between two), adds
    the two, and the C int32 partials are combined in rank order; then
    ``(f32(acc) * xscale) * wscale``, one rounding.  Given *row_amax* (a
    row-parallel shard's maxima over the whole input dim), every CTA takes
    those in place of the slots'.  Asserts that every partial stays in
    int32."""
    b, k = x.shape
    tk = weight_only.TILES_K[weight_only.W8A8]
    ranges = weight_only.split_ranges(k, 1, plan.cluster, tk)
    x32 = x.float()
    slots = torch.stack([x32[:, a:z].abs().amax(dim=1) for a, z in ranges])
    amax = slots.amax(dim=0) if row_amax is None else row_amax
    xscale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    xt = torch.zeros(plan.rows, k, dtype=torch.bfloat16)
    xt[:b] = x
    st = torch.ones(plan.rows)
    st[:b] = xscale
    xq = table_quantize(xt, st).long()
    assert not xq[b:].any()
    qt = q.long().t()  # the K-major A tiles: a row per weight column
    total = torch.zeros(q.shape[1], plan.rows, dtype=torch.long)
    for a, z in ranges:
        groups = [torch.zeros_like(total) for _ in range(weight_only.TC_GROUPS)]
        for t in range((z - a) // tk):
            for kk in range(tk // 32):
                ks = slice(a + t * tk + 32 * kk, a + t * tk + 32 * kk + 32)
                groups[t % weight_only.TC_GROUPS] += qt[:, ks] @ xq[:, ks].t()
        part = sum(groups[1:], groups[0])
        assert part.abs().max() < 2**31
        total += part
        assert total.abs().max() < 2**31
    acc = total.t()[:b].float()
    return ((acc * xscale[:, None]) * scale.float()).to(torch.bfloat16)


def _w8a8_operands(b, k, n, seed):
    """x at 3 sigma with a zero row and a row under the scale floor (its
    maximum / 127 < 1e-12), duplicated last row; q in [-127, 127]."""
    rng = np.random.default_rng(seed)
    x = 3 * rng.standard_normal((b, k)).astype(np.float32)
    x[1] = 0.0
    x[2] *= 1e-13
    x[-1] = x[0]
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.random(n) * 0.01 + 1e-4).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q), torch.from_numpy(s)


@pytest.mark.parametrize("b", [8, 17, 64])
def test_w8a8_kernel_model_is_bit_equal_to_plain_and_jax(b):
    """At SmolLM2-1.7B's 8192 x 2048 down projection (a 256-column slice;
    the columns do not change the order) and its 2048 x 8192 up
    projection's K: the planned cluster (6 and 2 CTAs, uneven and even K
    splits) and 1, 5 and 8 CTAs give the plain version's bits and the JAX
    package's reference's."""
    for k, n in ((8192, 2048), (2048, 8192)):
        x, q, s = _w8a8_operands(b, k, 256, seed=b + k)
        want = tmm.int8_matmul_dyn_reference(x, q, s)
        jax_want = np.asarray(jmm.int8_matmul_dyn_reference(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                                            jnp.asarray(q.numpy()), jnp.asarray(s.numpy())),
                              np.float32)
        np.testing.assert_array_equal(want.float().numpy(), jax_want)
        plan = weight_only.launch_plan(b, k, n, SMS, SMEM, 1, weight_only.W8A8, clusters=CLUSTERS)
        assert plan.rows == min(r for r in weight_only.W8A8_ROWS if r >= b)
        for c in sorted({plan.cluster, 1, 5, 8}):
            got = w8a8_kernel_model(x, q, s, dataclasses.replace(plan, cluster=c))
            assert torch.equal(got, want), (k, c)
            assert torch.equal(got[-1], got[0]) and not got[1].any()


@pytest.mark.parametrize("b", [8, 32])
def test_w8a8_kernel_model_with_the_rows_absmax_given_is_bit_equal_to_plain(b):
    """One rank's row-parallel shapes of two: SmolLM2-1.7B's wo (1024 ->
    2048) and w_down (4096 -> 2048), a 256-column slice, x one rank's half
    of K and ``row_amax`` each row's maximum over both halves (the other
    half larger in some rows): the planned cluster and 1, 5 and 8 CTAs give
    the plain version's bits with the same maxima."""
    for k in (1024, 4096):
        x2, q, s = _w8a8_operands(b, 2 * k, 256, seed=b + k)
        x2[::3, k:] = (x2[::3, k:].float() * 8).to(torch.bfloat16)
        row_amax = x2.float().abs().amax(dim=1)
        x, q = x2[:, :k].contiguous(), q[:k].contiguous()
        want = tmm.int8_matmul_dyn_reference(x, q, s, row_amax)
        assert not torch.equal(want, tmm.int8_matmul_dyn_reference(x, q, s))
        plan = weight_only.launch_plan(b, k, 2048, SMS, SMEM, 1, weight_only.W8A8, clusters=CLUSTERS)
        for c in sorted({plan.cluster, 1, 5, 8} & set(range(1, k // 128 + 1))):
            got = w8a8_kernel_model(x, q, s, dataclasses.replace(plan, cluster=c), row_amax)
            assert torch.equal(got, want), (k, c)


def test_w8a8_table_quantize_is_ieee_division_at_every_bf16_value():
    """At every finite bf16 value a row of scale s can hold (|x| <= 127 s),
    the table quantize equals clip(rint(x / s)) with x / s divided by IEEE
    division, for scales at the 1e-12 floor, RN(amax / 127) of random maxima
    across the bf16 range, and near the largest."""
    x = (torch.arange(65536, dtype=torch.int32) << 16).view(torch.float32)
    x = x[torch.isfinite(x)]
    rng = np.random.default_rng(11)
    amax = np.concatenate([10.0 ** rng.uniform(-40, 38.5, 48), [0.0, 1e-10, 127e-12, 1.0, 127.0, 3.38e38]])
    scales = np.maximum(np.float32(amax.astype(np.float32)) / np.float32(127), np.float32(1e-12))
    for s in scales.astype(np.float32):
        st = torch.tensor([s])
        xs = x[x.abs() <= max(127 * float(s), 0.0)].to(torch.bfloat16)[None]
        want = torch.clamp(torch.round(xs.float() / st[:, None].expand_as(xs.float())), -127, 127)
        assert torch.equal(table_quantize(xs, st), want), s


def _w8a8_k_limit() -> int:
    """``kMaxK`` of ``csrc/int8_matmul_dyn.cu``: the entry point refuses a
    larger K."""
    return int(re.search(r"constexpr int kMaxK = (\d+);", (_build.CSRC / "int8_matmul_dyn.cu").read_text()).group(1))


def test_w8a8_entry_point_k_limit_keeps_int32_sums_exact():
    """``kMaxK`` is the largest K with 127^2 K < 2^31 (the int32 sums stay
    exact), the entry point refuses past it, and it lies past every K that
    ``supports`` admits."""
    src = (_build.CSRC / "int8_matmul_dyn.cu").read_text()
    limit = _w8a8_k_limit()
    assert 127**2 * limit < 2**31 <= 127**2 * (limit + 1)
    assert "K > kMaxK" in src
    admitted = max(k for k in range(128, 1 << 18, 128) for n in (128, 256) if tmm.supports(8, k, n))
    assert admitted == 32768 <= limit


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


def test_library_name_changes_with_the_nvcc_version(monkeypatch):
    """The toolkit's version (what ``nvcc --version`` prints) is part of the
    library's name: another toolkit never loads a library built by the
    first, and the same one finds its own build."""
    monkeypatch.setattr(_build, "_nvcc_version", lambda: "Cuda compilation tools, release 12.8, V12.8.93\n")
    first = _build._library_path()
    assert _build._library_path() == first
    monkeypatch.setattr(_build, "_nvcc_version", lambda: "Cuda compilation tools, release 12.9, V12.9.86\n")
    assert _build._library_path() != first


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


@pytest.mark.cuda
def test_cuda_w8a8_entry_point_refuses_k_past_the_int32_range(cuda_device):
    k = (_w8a8_k_limit() // 128 + 1) * 128
    plan = weight_only.launch_plan(8, k, 128, SMS, SMEM, 1, weight_only.W8A8)
    args = (ctypes.c_int * 6)(*dataclasses.astuple(plan))
    err = _build.load().s2s_int8_matmul_dyn(None, None, None, None, None, 8, k, 128, args, None)
    assert err == 1  # cudaErrorInvalidValue, before any tensor map or launch
