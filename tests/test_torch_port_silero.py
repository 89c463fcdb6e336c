"""Silero VAD and the device resampler of the port against the JAX package.

- ``step`` against ``silero_vad.step`` over 8 ticks at B = 4 and
  ``scan_steps`` against ``jit_scan_steps``, with the JAX parameters carried
  across by ``weights.silero_params``: probabilities and the carry within
  1e-5 (both f32; the JAX package's own batched-vs-single bound).
- ``BatchedSileroVAD`` against the JAX ``BatchedSileroVAD`` on the same
  parameters and ticks: masked rows keep their carry; the port's versions of
  the JAX package's batched-vs-single, slot-isolation and reset tests
  (``tests/test_batcher.py``) and of its streaming and batched-session tests
  (``tests/test_vad.py``).
- ``torch_resample_poly`` against ``jax_resample_poly`` and scipy at 24k->16k,
  16k->24k and 48k->16k: scipy's output length, within 2e-5 (the JAX
  package's own bound against scipy, ``tests/test_audio_frontend.py``).
- On the card (``cuda`` marker): Silero's step against the same step on the
  CPU within 1e-5.

Inputs are made from numpy seeds.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from math import gcd

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from s2s_tpu.audio.resample import jax_resample_poly
from s2s_tpu.models import silero_vad as jax_silero
from s2s_tpu.runtime.batcher import BatchedSileroVAD as JaxBatchedSileroVAD
from s2s_tpu_torch.audio.resample import torch_resample_poly
from s2s_tpu_torch.models import silero_vad
from s2s_tpu_torch.runtime.batcher import BatchedSileroVAD
from s2s_tpu_torch.weights import silero_params

CHUNK = silero_vad.CHUNK
#: probabilities and carries, f32 on both sides
ATOL = 1e-5


@pytest.fixture(scope="module")
def params():
    """The JAX package's random-init tree (numpy) and the port's tensors."""
    tree = jax.tree_util.tree_map(np.asarray, jax_silero.init_params(jax.random.PRNGKey(0)))
    return tree, silero_params(tree, "cpu")


def _chunks(seed: int, n: int, b: int) -> np.ndarray:
    """Noise, a tone and silence across rows: (n, b, CHUNK) float32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, b, CHUNK)) * 0.1).astype(np.float32)
    t = np.arange(CHUNK) / silero_vad.SR
    x[:, 1 % b] = 0.3 * np.sin(2 * np.pi * 220 * t).astype(np.float32)
    x[:, -1] = 0.0
    return x


def _close(jax_tree, torch_state) -> None:
    for a, b in zip(jax_tree, torch_state):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL, rtol=0)


def test_silero_params_convert_the_convolution_layout(params):
    tree, p = params
    for jconv, conv in zip(tree["convs"], p["convs"]):
        k, ci, co = jconv["w"].shape
        assert conv["w"].shape == (co, ci, k)
        np.testing.assert_array_equal(conv["w"].numpy(), np.transpose(jconv["w"], (2, 1, 0)))


def test_step_matches_jax_over_eight_ticks(params):
    tree, p = params
    jstate, state = jax_silero.SileroState.create(4), silero_vad.SileroState.create(4)
    for chunk in _chunks(0, 8, 4):
        jprob, jstate = jax_silero.step(tree, jstate, jnp.asarray(chunk))
        prob, state = silero_vad.step(p, state, torch.from_numpy(chunk))
        assert prob.shape == (4,) and prob.dtype == torch.float32
        np.testing.assert_allclose(np.asarray(jprob), prob.numpy(), atol=ATOL, rtol=0)
        _close(jstate, state)


def test_scan_steps_matches_jax_jit_scan_steps(params):
    tree, p = params
    chunks = _chunks(1, 6, 3)
    jprobs, jstate = jax_silero.jit_scan_steps(tree, jax_silero.SileroState.create(3), jnp.asarray(chunks))
    probs, state = silero_vad.scan_steps(p, silero_vad.SileroState.create(3), torch.from_numpy(chunks))
    assert probs.shape == (6, 3)
    np.testing.assert_allclose(np.asarray(jprobs), probs.numpy(), atol=ATOL, rtol=0)
    _close(jstate, state)


def test_batched_service_matches_the_jax_service_and_masked_rows_keep_their_carry(params):
    tree, p = params
    jax_service = JaxBatchedSileroVAD(max_slots=4, params=jax.tree_util.tree_map(jnp.asarray, tree))
    service = BatchedSileroVAD(max_slots=4, params=p)
    x = _chunks(2, 6, 4)
    for tick, slots in enumerate(([0], [1, 3], [0, 1, 2, 3], [2], [], [3, 0])):
        before = [t.clone() for t in service._state]
        arrays = [x[tick, s] for s in slots]
        if slots:
            np.testing.assert_allclose(jax_service._run_batch(slots, arrays), service._run_batch(slots, arrays),
                                       atol=ATOL, rtol=0)
        _close(jax_service._state, service._state)
        for row in set(range(4)) - set(slots):
            for old, new in zip(before, service._state):
                assert torch.equal(old[row], new[row])


def test_batched_silero_matches_single(params):
    _, p = params
    service = BatchedSileroVAD(max_slots=4, params=p)
    single = silero_vad.SileroVAD(params=p)
    view = service.view(1)
    rng = np.random.RandomState(0)
    for _ in range(5):
        chunk = (rng.randn(CHUNK) * 0.1).astype(np.float32)
        assert abs(view(chunk) - single(chunk)) < ATOL


def test_batched_silero_slot_isolation_and_reset():
    service = BatchedSileroVAD(max_slots=4, seed=0)
    a, b = service.view(0), service.view(2)
    rng = np.random.RandomState(1)
    for _ in range(4):  # advance slot 0 with speech-ish noise; slot 2 stays silent
        a((rng.randn(CHUNK) * 0.3).astype(np.float32))
    p_b_silent = b(np.zeros(CHUNK, np.float32))
    p_fresh = BatchedSileroVAD(max_slots=4, seed=0).view(2)(np.zeros(CHUNK, np.float32))
    assert abs(p_b_silent - p_fresh) < ATOL
    a.reset_states()
    assert abs(a(np.zeros(CHUNK, np.float32)) - p_fresh) < ATOL
    service.close()


def test_single_session_model_is_deterministic_across_resets():
    vad = silero_vad.SileroVAD(seed=0)
    probs = [vad(np.random.RandomState(i).randn(CHUNK).astype(np.float32) * 0.1) for i in range(5)]
    assert all(0.0 <= q <= 1.0 for q in probs)
    vad.reset_states()
    probs2 = [vad(np.random.RandomState(i).randn(CHUNK).astype(np.float32) * 0.1) for i in range(5)]
    np.testing.assert_allclose(probs, probs2, atol=1e-6)
    with pytest.raises(ValueError, match="16000"):
        vad(np.zeros(CHUNK, np.float32), 8000)


def test_vad_handler_builds_silero_by_default():
    import threading
    from queue import Queue

    from s2s_tpu_torch.pipeline.turns import SpeculativeTurnTracker
    from s2s_tpu_torch.vad.handler import VADHandler

    handler = VADHandler(threading.Event(), Queue(), Queue(), setup_kwargs=dict(
        should_listen=threading.Event(), speculative_turns=SpeculativeTurnTracker(), smart_turn=False))
    model = handler.iterator.model
    assert isinstance(model, silero_vad.SileroVAD) and model.device.type == "cpu"


@pytest.mark.parametrize("rates", [(24_000, 16_000), (16_000, 24_000), (48_000, 16_000)])
@pytest.mark.parametrize("n", [1000, 4801])
def test_torch_resample_poly_matches_jax_and_scipy(rates, n):
    from_rate, to_rate = rates
    x = (np.random.default_rng(n).standard_normal(n) * 0.3).astype(np.float32)
    g = gcd(from_rate, to_rate)
    ref = scipy.signal.resample_poly(x, to_rate // g, from_rate // g)
    ours = torch_resample_poly(torch.from_numpy(x), from_rate, to_rate).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(ours, np.asarray(jax_resample_poly(x, from_rate, to_rate)), atol=2e-5, rtol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_step_matches_the_cpu(cuda_device, params):
    tree, p = params
    p_dev = silero_params(tree, cuda_device)
    state, state_dev = silero_vad.SileroState.create(16), silero_vad.SileroState.create(16, device=cuda_device)
    for chunk in _chunks(3, 8, 16):
        prob, state = silero_vad.step(p, state, torch.from_numpy(chunk))
        prob_dev, state_dev = silero_vad.step(p_dev, state_dev, torch.from_numpy(chunk).to(cuda_device))
        np.testing.assert_allclose(prob_dev.cpu().numpy(), prob.numpy(), atol=ATOL, rtol=0)
