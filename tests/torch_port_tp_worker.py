"""One rank of the two-rank gloo group that ``tests/test_torch_port_tp.py`` runs.

``python tests/torch_port_tp_worker.py DIR RANK WORLD PORT``: rank 0 starts
a ``TCPStore`` on 127.0.0.1:PORT and every rank joins the port's
tensor-parallel groups (``parallel.mesh.TPRuntime``, two ranks on the CPU
over gloo).  From ``DIR/inputs.npz`` (written by the test: the JAX package's
tiny decoder-LM and Qwen3-TTS trees, converted, and a prompt) each rank
takes its shard (``registry._tp_shard_lm``) and runs, over the ranks:

- the tiny f32 LM's ``prefill_slot`` and a 6-token ``decode_chunk_tail``,
  on the tree as it is, quantized to int8, to W8A8 (``int8-dyn``) and to
  packed int4 (whole, then split), as ``tests/test_tp_serving.py``'s
  sharded chunk runs;
- the tiny talker's ``talker_prefill`` and a 4-frame
  ``decode_chunk_audio``, as ``tests/test_sharded_inference.py``'s, on the
  talker as it is and quantized to W8A8;
- 16 tokens of sampled decode (temperature 0.7) of the f32 LM through the
  local LLM handler on the batched engine's single-session programs: rank
  0 runs the handler, the other ranks follow; rank 0 then samples again on
  one rank (the handler on the whole tree), with the same seed.

Rank 0 writes ``DIR/outputs.npz`` (the tokens and the audio) and
``DIR/outputs.json`` (the sums and maxima each run issued, by group, and
the sampled tokens).

``... RANK WORLD PORT lm``: the f32 LM's chunk alone (the tree's shard and
its kv heads in ``outputs.json``), for a world whose ranks do not divide
the heads.

``... RANK WORLD PORT orphan``: rank 0 joins the groups and exits at once;
every other rank then waits for a command, as a follower does, and must
fail (exit 1) instead of waiting on.  Imports no ``jax``.
"""

import datetime
import json
import os
import queue
import sys
import threading

import numpy as np
import torch
import torch.distributed as dist

from s2s_tpu_torch import weights
from s2s_tpu_torch.models import decoder_lm, qwen3_tts
from s2s_tpu_torch.ops.quant import quantize_tree
from s2s_tpu_torch.parallel import batched_decode as bd
from s2s_tpu_torch.parallel.mesh import TPLayout, TPRuntime
from s2s_tpu_torch.registry import _tp_shard_lm, unflatten_params


def lm_chunk(params, cfg, prompt, tp) -> np.ndarray:
    """Slot 0's prefill (12 of 16 tokens), then 6 tail steps with slot 1 idle."""
    state = bd.init_multi_state(cfg, 2, max_t=64, tp=tp)
    tok, state = bd.prefill_slot(params, cfg, prompt, 12, state, 0, tp)
    tokens = torch.zeros((2,), dtype=torch.int32)
    tokens[0] = tok
    toks, _, _, _, _ = bd.decode_chunk_tail(params, cfg, tokens, state, 6, -1, torch.tensor([True, False]), tp)
    return toks[:, 0].numpy()


class TokenText:
    """A tokenizer whose text is the token ids (``"5,17,"``): a reply's
    text gives back its tokens exactly; no EOS."""

    eos_id = -1

    def encode(self, text: str) -> list[int]:
        return list(text.encode())

    def decode(self, ids) -> str:
        return "".join(f"{int(i)}," for i in ids)


SAMPLED = {"temperature": 0.7}
SAMPLED_TOKENS = 16


def sampled_tokens(handler) -> list[int]:
    text = "".join(handler._jax_generate([{"role": "user", "content": "hi"}], max_new=SAMPLED_TOKENS))
    return [int(t) for t in text.split(",") if t]


def sampled(tree, cfg, tp) -> list[int] | None:
    """Rank 0: the handler's sampled tokens on the engine over the ranks;
    the other ranks: the engine's follower loop (None)."""
    from s2s_tpu_torch.llm.local_backend import LocalTorchLLMHandler
    from s2s_tpu_torch.parallel.session_scheduler import BatchedLMScheduler

    engine = BatchedLMScheduler(_tp_shard_lm(tree, cfg, tp, "the tiny LM"), cfg, n_slots=2, tp=tp)
    if tp.rank:
        engine.follow()
        return None
    handler = LocalTorchLLMHandler(threading.Event(), queue.Queue(), queue.Queue(),
                                   setup_kwargs=dict(tokenizer=TokenText(), shared_lm=engine, gen_kwargs=SAMPLED))
    try:
        return sampled_tokens(handler)
    finally:
        engine.stop_followers()


def one_rank_sampled(tree) -> list[int]:
    from s2s_tpu_torch.llm.local_backend import LocalTorchLLMHandler

    handler = LocalTorchLLMHandler(threading.Event(), queue.Queue(), queue.Queue(),
                                   setup_kwargs=dict(tokenizer=TokenText(), params=tree, gen_kwargs=SAMPLED))
    return sampled_tokens(handler)


def orphan(runtime: TPRuntime) -> None:
    if runtime.rank == 0:
        os._exit(0)
    try:
        runtime.group("lm").broadcast()
    except Exception as e:  # noqa: BLE001 - the leader is gone: the exit code says so
        print(f"follower failed: {e!r}"[:300])
        sys.exit(1)


def main(out_dir: str, rank: int, world: int, port: int, mode: str = "programs") -> None:
    store = dist.TCPStore("127.0.0.1", port, world, rank == 0, timeout=datetime.timedelta(seconds=60))
    runtime = TPRuntime(rank, TPLayout(("cpu",) * world, "gloo"), store, timeout_s=60)
    if mode == "orphan":
        orphan(runtime)
    inputs = dict(np.load(f"{out_dir}/inputs.npz"))
    fields = json.loads(str(inputs.pop("lm_cfg")))
    cfg = decoder_lm.DecoderLMConfig(**{**fields, "dtype": torch.float32})
    qcfg = qwen3_tts.Qwen3TTSConfig.tiny()
    prompt = torch.from_numpy(inputs.pop("prompt"))
    text = torch.from_numpy(inputs.pop("text"))
    lm_tree = weights.tree_to_torch(unflatten_params({k[3:]: v for k, v in inputs.items() if k.startswith("lm/")}),
                                    "cpu")
    tts_tree = weights.qwen3_tts_params(
        unflatten_params({k[4:]: v for k, v in inputs.items() if k.startswith("tts/")}), "cpu")
    lm_tp, tts_tp = runtime.group("lm"), runtime.group("tts")
    out, collectives, info = {}, {}, {}

    def counted(name: str, group, fn):
        before = group.collectives
        result = fn()
        collectives[name] = group.collectives - before
        return result

    if mode == "lm":
        shard = _tp_shard_lm(lm_tree, cfg, lm_tp, "the tiny LM")
        out["lm_f32"] = counted("lm_f32", lm_tp, lambda: lm_chunk(shard, cfg, prompt, lm_tp))
        info = {"widths": {k: list(v.shape) for k, v in shard["layers"].items()},
                "kv_heads": decoder_lm.local_kv_heads(cfg, lm_tp)}
    else:
        for name, tree in (("f32", lm_tree), ("int8", quantize_tree(lm_tree, min_size=0)),
                           ("int8-dyn", quantize_tree(lm_tree, min_size=0, act_quant=True)),
                           ("int4", quantize_tree(lm_tree, min_size=0, bits=4))):
            shard = _tp_shard_lm(tree, cfg, lm_tp, "the tiny LM")
            out[f"lm_{name}"] = counted(f"lm_{name}", lm_tp, lambda: lm_chunk(shard, cfg, prompt, lm_tp))
        for name, talker in (("f32", tts_tree["talker"]),
                             ("int8-dyn", quantize_tree(tts_tree["talker"], min_size=0, act_quant=True))):
            params = dict(tts_tree, talker=_tp_shard_lm(talker, qcfg.lm, tts_tp, "the tiny talker", talker=True))

            def chunk():
                state = decoder_lm.init_decode_state(qcfg.lm, 1, max_t=64, tp=tts_tp)
                tstate = qwen3_tts.talker_prefill(params, qcfg, text, params["speakers"][:1], state, tts_tp)
                return qwen3_tts.decode_chunk_audio(params, qcfg, tstate,
                                                    torch.zeros((0, qcfg.n_q), dtype=torch.int32), 4, tts_tp)[0]

            out[f"talker_{name}"] = counted(f"talker_{name}", tts_tp, chunk).numpy()
        info["sampled"] = sampled(lm_tree, cfg, lm_tp)
        if rank == 0:
            info["one_rank_sampled"] = one_rank_sampled(lm_tree)
    runtime.shutdown()
    if rank == 0:
        np.savez(f"{out_dir}/outputs.npz", **out)
        with open(f"{out_dir}/outputs.json", "w") as f:
            json.dump({"collectives": collectives, **info}, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), *sys.argv[5:])
