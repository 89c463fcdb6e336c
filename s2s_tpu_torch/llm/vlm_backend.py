"""Vision-language local backend on PyTorch (port of
``s2s_tpu/llm/vlm_backend.py``; reference ``VisionLanguageModelHandler``,
``LLM/language_model.py:808-1013``).

Extends the port's local LLM: user messages carrying ``input_image`` data
URLs are decoded to pixels, encoded by the SigLIP tower
(:mod:`s2s_tpu_torch.models.vision`, its attention on the flash kernel) and
spliced as prefix embeddings in front of the tokenized chat through the
decoder's embedding-level prefill; greedy decoding then runs in the parent's
chunks.  Consumed images are stripped from history by the base class's
write-back (``strip_images``).  A turn without an image is the parent's.
"""

from __future__ import annotations

import logging
from typing import Any, Iterator

import torch

from s2s_tpu_torch.llm.local_backend import LocalTorchLLMHandler, render_chat_template
from s2s_tpu_torch.llm.utils import image_url_to_pil
from s2s_tpu_torch.runtime.device_scheduler import Lane
from s2s_tpu_torch.utils.common import next_power_of_2

logger = logging.getLogger(__name__)


def extract_image_urls(messages: list[dict[str, Any]]) -> list[str]:
    urls = []
    for msg in messages:
        content = msg.get("content")
        if isinstance(content, list):
            for part in content:
                if isinstance(part, dict) and part.get("type") == "input_image" and part.get("image_url"):
                    urls.append(part["image_url"])
    return urls


class VisionLocalTorchLLMHandler(LocalTorchLLMHandler):
    def setup(self, vision_params: Any | None = None, vision_config: Any | None = None, **kwargs) -> None:
        super().setup(**kwargs)
        if self._generate_fn is None:
            from s2s_tpu_torch.models import vision

            self.vision_cfg = vision_config or vision.VisionConfig(d_out=self.cfg.d_model)
            if vision_params is None:
                logger.warning("VisionLocalTorchLLMHandler: random-init vision weights")
                vision_params = vision.init_params(
                    self.vision_cfg, torch.Generator(device=self.device).manual_seed(7), self.device)
            self.vision_params = vision_params

    def _jax_generate(self, messages, max_new=None, cancel_check=None, lane=Lane.INTERACTIVE) -> Iterator[str]:
        image_urls = extract_image_urls(messages)
        if not image_urls:
            yield from super()._jax_generate(messages, max_new, cancel_check, lane)
            return

        from s2s_tpu_torch.models import decoder_lm, vision

        max_new = max_new or self.max_new_tokens
        prefixes = []
        for url in image_urls[:4]:  # bound the vision prefix
            try:
                pixels = vision.preprocess_image(image_url_to_pil(url), size=self.vision_cfg.image_size)
            except Exception:
                logger.exception("Failed to decode input_image; skipping")
                continue
            prefixes.append(vision.encode_image(self.vision_params, self.vision_cfg,
                                                torch.from_numpy(pixels).to(self.device)))
        prompt = render_chat_template(messages)
        ids = self.tokenizer.encode(prompt)[: self.cfg.max_seq_len - max_new - 1]
        n_img = sum(p.shape[1] for p in prefixes)
        bucket = min(next_power_of_2(max(len(ids) + n_img, 16)), self.cfg.max_seq_len)
        text_emb = self.params["embed"][torch.tensor(ids, dtype=torch.long, device=self.device)][None]
        embeds = torch.cat([*prefixes, text_emb.to(self.cfg.dtype)], dim=1)
        true_len = embeds.shape[1]
        if true_len < bucket:
            embeds = torch.cat([embeds, embeds.new_zeros((1, bucket - true_len, self.cfg.d_model))], dim=1)

        with self.scheduler.slot(lane):
            state = decoder_lm.init_decode_state(
                self.cfg, 1, max_t=min(bucket + max_new, self.cfg.max_seq_len), device=self.device
            )
            hidden, state = decoder_lm.prefill_embeds(self.params, self.cfg, embeds, state, true_len)
            head = self.params["embed"].T if self.cfg.tie_embeddings else self.params["lm_head"]
            logits = torch.matmul(hidden, head).float()
            yield from self._greedy_decode(torch.argmax(logits, dim=-1).to(torch.int32), state, max_new,
                                           cancel_check)
