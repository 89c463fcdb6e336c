"""Local LLM backend on PyTorch: the JAX package's ``LocalJAXLLMHandler``
with its device methods replaced (port of ``s2s_tpu/llm/local_backend.py``).

Everything host-side (chat template, prompt fitting, UTF-8-boundary
streaming, cancellation, token caps, speculative first-sentence generation)
is inherited unchanged.  With a cross-session batched engine (``shared_lm``,
:class:`s2s_tpu_torch.parallel.session_scheduler.BatchedLMScheduler`) greedy
turns decode through it, as in the JAX handler; the engine's
``prompt_capacity`` and ``start`` serve the inherited prompt fitting and
speculation.
"""

from __future__ import annotations

import logging
from typing import Any, Iterator

import numpy as np
import torch

from s2s_tpu.llm.local_backend import LocalJAXLLMHandler, SimpleCharTokenizer, render_chat_template
from s2s_tpu.runtime.device_scheduler import Lane
from s2s_tpu.utils.common import next_power_of_2
from s2s_tpu_torch.models import decoder_lm

logger = logging.getLogger(__name__)


def lm_config(model_size: str) -> decoder_lm.DecoderLMConfig:
    return {
        "tiny": decoder_lm.DecoderLMConfig.tiny,
        "smollm2-360m": decoder_lm.DecoderLMConfig.smollm2_360m,
        "smollm2-1.7b": decoder_lm.DecoderLMConfig.smollm2_1_7b,
        "qwen3-1.7b": decoder_lm.DecoderLMConfig.qwen3_1_7b,
    }[model_size]()


class LocalTorchLLMHandler(LocalJAXLLMHandler):
    """LLM stage running the port's decoder on an explicit device."""

    def setup(self, device: torch.device | str = "cpu", **kwargs: Any) -> None:
        self.device = torch.device(device)
        super().setup(**kwargs)

    def _build_jax_generator(self, model_size, params, tokenizer):
        cfg = lm_config(model_size)
        if params is None:
            logger.warning("LocalTorchLLMHandler: random-init weights (no checkpoint provided)")
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = decoder_lm.init_params(cfg, gen, self.device)
        self.cfg, self.params = cfg, params
        self.tokenizer = tokenizer or SimpleCharTokenizer()

    def _jax_generate(self, messages, max_new=None, cancel_check=None, lane=Lane.INTERACTIVE) -> Iterator[str]:
        max_new = max_new or self.max_new_tokens
        prompt = render_chat_template(messages)
        ids = self._fit_prompt(self.tokenizer.encode(prompt), max_new)
        bucket = min(next_power_of_2(max(len(ids), 16)), self.cfg.max_seq_len)
        padded = np.zeros(bucket, np.int32)
        padded[: len(ids)] = ids
        temperature = float(self.gen_kwargs.get("temperature", 0.0))
        if self.shared_lm is not None and temperature <= 0:
            adopted = self._adopt_speculation(ids, max_new, cancel_check)
            if adopted is not None:
                # the speculative slot has been decoding this exact prompt
                yield from self._decode_token_stream(adopted)
                return
            # this turn shares the batched engine's dispatch stream
            yield from self._decode_token_stream(self.shared_lm.generate(ids, max_new, cancel_check=cancel_check))
            return
        chunk = max(1, int(self.gen_kwargs.get("decode_chunk_tokens", 8)))
        with self.scheduler.slot(lane):
            state = decoder_lm.init_decode_state(
                self.cfg, 1, max_t=min(bucket + max_new, self.cfg.max_seq_len), device=self.device
            )
            tokens = torch.from_numpy(padded[None]).to(self.device)
            logits, state = decoder_lm.prefill(self.params, self.cfg, tokens, state, len(ids))
            if temperature > 0:
                yield from self._sampled_decode(logits, state, max_new, temperature, cancel_check)
                return
            # greedy: decode in chunks — one host read per `chunk` tokens
            # (cancellation polls between chunks)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            emitted = 0
            pending: list[int] = []
            while emitted < max_new:
                n = min(chunk, max_new - emitted)
                toks_dev, _eos, token, state = decoder_lm.decode_chunk(
                    self.params, self.cfg, token, state, n, self.tokenizer.eos_id
                )
                toks = toks_dev[:, 0].cpu().numpy()
                valid = n
                hit_eos = False
                nz = np.nonzero(toks == self.tokenizer.eos_id)[0]
                if len(nz):
                    valid, hit_eos = int(nz[0]), True
                for t in toks[:valid]:
                    pending.append(int(t))
                    piece = self.tokenizer.decode(pending)
                    if not piece.endswith("�"):  # only emit at UTF-8 boundaries
                        yield piece
                        pending = []
                emitted += valid
                if hit_eos:
                    break
                if cancel_check is not None and cancel_check():
                    break
            if pending:
                yield self.tokenizer.decode(pending)

    def _sampled_decode(self, logits, state, max_new, temperature, cancel_check) -> Iterator[str]:
        """Temperature sampling with an explicit generator, seeded afresh for
        each generation so that a reply is reproducible."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        emitted = 0
        pending: list[int] = []
        token = int(torch.argmax(logits[0]))
        while emitted < max_new:
            if token == self.tokenizer.eos_id:
                break
            if cancel_check is not None and cancel_check():
                break
            pending.append(token)
            piece = self.tokenizer.decode(pending)
            if not piece.endswith("�"):
                yield piece
                pending = []
            emitted += 1
            step_logits, state = decoder_lm.decode_step(
                self.params, self.cfg, torch.tensor([token], dtype=torch.int32, device=self.device), state
            )
            probs = torch.softmax(step_logits[0] / temperature, dim=-1)
            token = int(torch.multinomial(probs, 1, generator=gen))
        if pending:
            yield self.tokenizer.decode(pending)
