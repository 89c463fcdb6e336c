"""SmolVLM's vision prefix in PyTorch, the port of ``s2s_tpu/models/vision.py``
(the SigLIP tower and pixel-shuffle connector of transformers'
``SmolVLMForConditionalGeneration``).

The same tree and numerics as the JAX package (bf16 activations, every
product accumulated in f32, norms and the gelu in f32):

- **Vision tower** — SigLIP ViT: a valid patch convolution (kernel =
  stride = patch) as one product of each patch with the ``(p*p*3, d)``
  weight, position embeddings gathered by NaViT's bucketized fractional
  coordinates (not an arange), pre-LN attention blocks with a gelu-tanh
  MLP, a post layernorm.  The attention is unmasked, so it goes through
  :func:`s2s_tpu_torch.models.common.attention`: on the card the flash
  kernel, one launch a layer.  The JAX einsum rounds the probabilities to
  bf16 before the PV product and the kernel does not: equal in f32 (the
  tiny tests), a stated tolerance at full width.
- **Connector** — pixel shuffle (space-to-depth by ``scale_factor``), then
  one bias-free linear into the LM's embedding width: 1,024 patches ->
  64 image tokens at ``scale_factor`` 4.

:func:`s2s_tpu_torch.llm.vlm_backend` splices the output as prefix
embeddings in front of the chat through the decoder's embedding-level
prefill.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from s2s_tpu_torch import weights
from s2s_tpu_torch.models.common import HostStateDict, Params, attention, layer_norm, tree_to_device
from s2s_tpu_torch.models.decoder_lm import normal


@dataclass(frozen=True)
class VisionConfig:
    """Defaults = SmolVLM2-256M vision tower (SigLIP-B/16-512-class)."""

    image_size: int = 512
    patch: int = 16
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    layer_norm_eps: float = 1e-6
    scale_factor: int = 4
    d_out: int = 576  # LM embedding width (SmolLM2-135M/360M/1.7B per variant)
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def n_image_tokens(self) -> int:
        return self.n_patches // (self.scale_factor ** 2)

    @staticmethod
    def test_tiny() -> "VisionConfig":
        return VisionConfig(image_size=32, patch=8, d_model=32, n_layers=2, n_heads=4,
                            d_ff=64, scale_factor=2, d_out=64, dtype=torch.float32)


def _lin(x, w, b=None):
    out = x.float() @ w.float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def position_ids(cfg: VisionConfig, grid: int) -> np.ndarray:
    """NaViT's fractional-coordinate bucketize (modeling_smolvlm.py:138-160):
    at full square resolution the (1-1e-6) nudge shifts every coordinate
    below its own boundary, giving e.g. [0, 0, 1, 2] per side."""
    side = cfg.image_size // cfg.patch
    bounds = np.arange(1 / side, 1.0, 1 / side)
    frac = np.arange(grid) / grid * (1 - 1e-6)
    bucket = np.searchsorted(bounds, frac, side="right")
    return (bucket[:, None] * side + bucket[None, :]).reshape(-1)


@torch.inference_mode()
def encode_image(params: Params, cfg: VisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels: (1, H, W, 3) normalized floats -> (1, n_image_tokens, d_out)."""
    b, hgt, wid, c = pixels.shape
    p, d = cfg.patch, cfg.d_model
    gh, gw = hgt // p, wid // p
    # patch embedding: each (p, p, 3) patch times the HWIO weight, in f32
    patches = pixels.to(cfg.dtype)[:, : gh * p, : gw * p].reshape(b, gh, p, gw, p, c)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
    x = (patches.float() @ params["patch_w"].reshape(p * p * c, d).float()).to(cfg.dtype) + params["patch_b"]
    pos = torch.from_numpy(position_ids(cfg, gh)).to(x.device)
    x = x + params["pos_emb"][pos][None]
    nh, hd = cfg.n_heads, cfg.head_dim
    t = x.shape[1]

    def heads(y):
        return y.reshape(b, t, nh, hd).transpose(1, 2)

    for lp in params["layers"]:
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        q, k, v = (heads(_lin(h, lp[f"{n}_w"], lp[f"{n}_b"])) for n in "qkv")
        a = attention(q, k, v, scale=hd ** -0.5).transpose(1, 2).reshape(b, t, d)
        x = x + _lin(a, lp["o_w"], lp["o_b"])
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        h = _lin(h, lp["fc1_w"], lp["fc1_b"])
        h = F.gelu(h.float(), approximate="tanh").to(cfg.dtype)
        x = x + _lin(h, lp["fc2_w"], lp["fc2_b"])
    x = layer_norm(x, params["post_ln_w"], params["post_ln_b"], cfg.layer_norm_eps)

    # connector: pixel shuffle (modeling_smolvlm.py:457-467) + projection
    s = cfg.scale_factor
    side = math.isqrt(t)
    x = x.reshape(b, side, side // s, d * s)
    x = x.transpose(1, 2)
    x = x.reshape(b, side // s, side // s, d * s * s)
    x = x.transpose(1, 2)
    x = x.reshape(b, t // (s * s), d * s * s)
    return _lin(x, params["proj_w"])


# SigLIP normalization (mean/std 0.5 — transformers SmolVLMImageProcessor)
_MEAN = 0.5
_STD = 0.5


def preprocess_image(img, size: int = 512) -> np.ndarray:
    """PIL image (or (H, W, 3) uint8 array) -> (1, S, S, 3) normalized."""
    if hasattr(img, "resize"):  # PIL
        img = img.convert("RGB").resize((size, size))
        arr = np.asarray(img, np.float32)
    else:
        arr = np.asarray(img, np.float32)
        if arr.shape[:2] != (size, size):  # nearest-neighbor host resize
            ys = (np.arange(size) * arr.shape[0] / size).astype(np.int32)
            xs = (np.arange(size) * arr.shape[1] / size).astype(np.int32)
            arr = arr[ys][:, xs]
    arr = (arr / 255.0 - _MEAN) / _STD
    return arr[None]


def init_params(cfg: VisionConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init weights drawn from *gen* on *device*: the JAX package's
    distributions and tree, not its numbers."""
    d, dt = cfg.d_model, cfg.dtype

    def rnd(shape, scale):
        return normal(gen, shape, scale, dt, device)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    def layer():
        return {
            "ln1_w": ones(d), "ln1_b": zeros(d),
            "q_w": rnd((d, d), d ** -0.5), "q_b": zeros(d),
            "k_w": rnd((d, d), d ** -0.5), "k_b": zeros(d),
            "v_w": rnd((d, d), d ** -0.5), "v_b": zeros(d),
            "o_w": rnd((d, d), d ** -0.5), "o_b": zeros(d),
            "ln2_w": ones(d), "ln2_b": zeros(d),
            "fc1_w": rnd((d, cfg.d_ff), d ** -0.5), "fc1_b": zeros(cfg.d_ff),
            "fc2_w": rnd((cfg.d_ff, d), cfg.d_ff ** -0.5), "fc2_b": zeros(d),
        }

    return weights.vision_params({
        "patch_w": rnd((cfg.patch, cfg.patch, 3, d), (cfg.patch * cfg.patch * 3) ** -0.5),
        "patch_b": zeros(d),
        "pos_emb": rnd((cfg.n_patches, d), 0.02),
        "layers": [layer() for _ in range(cfg.n_layers)],
        "post_ln_w": ones(d), "post_ln_b": zeros(d),
        "proj_w": rnd((d * cfg.scale_factor ** 2, cfg.d_out), (d * cfg.scale_factor ** 2) ** -0.5),
    }, device)


# ---------------------------------------------------------------------------
# checkpoint conversion: the JAX package's numpy converter, its tree on a device
# ---------------------------------------------------------------------------


def convert_hf_state_dict(sd: dict, cfg: VisionConfig = VisionConfig(), device: torch.device | str = "cpu") -> Params:
    """SmolVLMForConditionalGeneration state dict (``model.vision_model.*``,
    ``model.connector.*``) -> the JAX package's tree on *device*."""
    sd = HostStateDict(sd)

    def t(name):
        for prefix in ("model.", ""):
            if prefix + name in sd:
                return np.asarray(sd[prefix + name], np.float32)
        raise KeyError(name)

    def lin_t(name):
        return t(name).T

    layers = []
    for i in range(cfg.n_layers):
        pre = f"vision_model.encoder.layers.{i}"
        layers.append({
            "ln1_w": t(f"{pre}.layer_norm1.weight"), "ln1_b": t(f"{pre}.layer_norm1.bias"),
            "q_w": lin_t(f"{pre}.self_attn.q_proj.weight"), "q_b": t(f"{pre}.self_attn.q_proj.bias"),
            "k_w": lin_t(f"{pre}.self_attn.k_proj.weight"), "k_b": t(f"{pre}.self_attn.k_proj.bias"),
            "v_w": lin_t(f"{pre}.self_attn.v_proj.weight"), "v_b": t(f"{pre}.self_attn.v_proj.bias"),
            "o_w": lin_t(f"{pre}.self_attn.out_proj.weight"), "o_b": t(f"{pre}.self_attn.out_proj.bias"),
            "ln2_w": t(f"{pre}.layer_norm2.weight"), "ln2_b": t(f"{pre}.layer_norm2.bias"),
            "fc1_w": lin_t(f"{pre}.mlp.fc1.weight"), "fc1_b": t(f"{pre}.mlp.fc1.bias"),
            "fc2_w": lin_t(f"{pre}.mlp.fc2.weight"), "fc2_b": t(f"{pre}.mlp.fc2.bias"),
        })
    return tree_to_device({
        # torch conv (O, I, kh, kw) -> HWIO
        "patch_w": t("vision_model.embeddings.patch_embedding.weight").transpose(2, 3, 1, 0),
        "patch_b": t("vision_model.embeddings.patch_embedding.bias"),
        "pos_emb": t("vision_model.embeddings.position_embedding.weight"),
        "layers": layers,
        "post_ln_w": t("vision_model.post_layernorm.weight"),
        "post_ln_b": t("vision_model.post_layernorm.bias"),
        "proj_w": lin_t("connector.modality_projection.proj.weight"),
    }, device)
