"""Sharded training/fine-tuning step for the decoder LM (port of ``s2s_tpu/parallel/training.py``).

The inference framework's growth path: voice-agent deployments fine-tune
the local LLM on their own cards.  One AdamW step over the ("data",
"model") mesh of :mod:`s2s_tpu_torch.parallel.mesh`: the batch split on
data, the megatron layer splits on model (DTensor inserts the
collectives), gradients by ``torch.autograd``.

The optimizer is optax's ``adamw`` with its defaults, written as tensor
ops in optax's order so that its state (:class:`ScaleByAdamState`: count,
mu, nu in the parameters' dtype) equals the JAX package's leaf by leaf.
``torch.optim.AdamW`` is not used: its decoupled ``p * (1 - lr * wd)``
rounds otherwise in bf16 (at lr 1e-4 and wd 0.01 the factor is 1.0).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor
from torch.utils import _pytree as pytree

from s2s_tpu_torch.models import decoder_lm
from s2s_tpu_torch.models.decoder_lm import DecoderLMConfig
from s2s_tpu_torch.parallel.mesh import data_sharded, shard_params


class ScaleByAdamState(NamedTuple):
    """optax's Adam state: the step count (int32) and the first and second
    moments as parameter trees."""

    count: torch.Tensor
    mu: Any
    nu: Any


class TrainState(NamedTuple):
    params: Any
    opt_state: ScaleByAdamState
    step: torch.Tensor


#: ``optax.adamw``'s defaults, which the JAX package's optimizer keeps
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


class AdamW(NamedTuple):
    """``optax.adamw(lr, weight_decay=wd)`` at optax's defaults (:data:`B1`,
    :data:`B2`, :data:`EPS`, :data:`EPS_ROOT`), moments in the parameters'
    dtype."""

    lr: float
    weight_decay: float

    def init(self, params) -> ScaleByAdamState:
        device = pytree.tree_leaves(params)[0].device
        return ScaleByAdamState(torch.zeros((), dtype=torch.int32, device=device),
                                pytree.tree_map(torch.zeros_like, params), pytree.tree_map(torch.zeros_like, params))

    def update(self, grads, state: ScaleByAdamState, params) -> tuple[Any, ScaleByAdamState]:
        """(new params, new state).  optax's order: the moments, the count,
        the bias corrections (computed in f32, divided in the moment's
        dtype), ``m / (sqrt(v + eps_root) + eps)``, ``+ wd * p``, ``* -lr``,
        then ``p + u`` cast to p's dtype.  Each constant is first rounded to
        the dtype of the tensor it meets, as JAX rounds a weakly typed
        Python scalar (in bf16, b2 0.999 is 1.0)."""
        count = state.count + 1
        correction = {b: 1 - torch.pow(torch.tensor(b, dtype=torch.float32, device=count.device), count.float())
                      for b in (B1, B2)}

        def c(value: float, like: torch.Tensor) -> float:
            return torch.tensor(value, dtype=like.dtype).item()

        mu = pytree.tree_map(lambda g, m: c(1 - B1, g) * g + c(B1, m) * m, grads, state.mu)
        nu = pytree.tree_map(lambda g, v: c(1 - B2, g) * (g * g) + c(B2, v) * v, grads, state.nu)

        def step(p, m, v):
            m_hat = m / correction[B1].to(m.dtype)
            v_hat = v / correction[B2].to(v.dtype)
            u = m_hat / (torch.sqrt(v_hat + c(EPS_ROOT, v_hat)) + c(EPS, v_hat))
            u = u + c(self.weight_decay, p) * p
            return (p + c(-self.lr, u) * u).to(p.dtype)

        return pytree.tree_map(step, params, mu, nu), ScaleByAdamState(count, mu, nu)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr, weight_decay)


def make_sharded_train_step(cfg: DecoderLMConfig, mesh: DeviceMesh, lr: float = 1e-4
                            ) -> tuple[Callable[[torch.Generator], TrainState], Callable]:
    """Returns (init_fn(gen) or init_fn(params=tree) -> TrainState, run_step).

    ``run_step(state, tokens, targets, mask) -> (loss, state)`` places the
    batch on ("data", None), takes the loss and its gradients and applies
    the AdamW update; parameters are model-sharded DTensors.  The step
    returns new tensors and leaves the old state's alone; the old state may
    be dropped (JAX donates it)."""
    tx = make_optimizer(lr)
    specs = decoder_lm.param_shardings(cfg)
    batch = data_sharded(mesh, None)

    def init_fn(gen: torch.Generator | None = None, params=None) -> TrainState:
        """Random weights drawn from *gen* (a generator of the mesh's
        device), or the given *params* (a converted checkpoint), sharded."""
        device = torch.device(mesh.device_type, torch.cuda.current_device()) if mesh.device_type == "cuda" else "cpu"
        if params is None:
            params = decoder_lm.init_params(cfg, gen, device)
        params = shard_params(pytree.tree_map(lambda p: p.to(device), params), specs, mesh)
        return TrainState(params, tx.init(params), torch.zeros((), dtype=torch.int32, device=device))

    def run_step(state: TrainState, tokens, targets, mask):
        tokens, targets, mask = (distribute_tensor(t.to(mesh.device_type), mesh, batch)
                                 for t in (tokens, targets, mask))
        loss, grads = decoder_lm.value_and_grad(state.params, cfg, tokens, targets, mask)
        # each gradient placed as its parameter (DTensor may hand back a
        # data-parallel partial sum scattered over the layer axis), so that
        # the new state keeps param_shardings' placements
        grads = pytree.tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements), grads, state.params)
        with torch.no_grad():
            params, opt_state = tx.update(grads, state.opt_state, state.params)
        return loss.full_tensor(), TrainState(params, opt_state, state.step + 1)

    return init_fn, run_step
