"""One rank of the two-rank gloo group that ``tests/test_torch_port_tp.py`` runs.

``python tests/torch_port_tp_worker.py DIR RANK WORLD PORT``: rank 0 starts
a ``TCPStore`` on 127.0.0.1:PORT and every rank joins the port's
tensor-parallel groups (``parallel.mesh.TPRuntime``, two ranks on the CPU
over gloo).  From ``DIR/inputs.npz`` (written by the test: the JAX package's
tiny decoder-LM and Qwen3-TTS trees, converted, and a prompt) each rank
takes its shard (``registry._tp_shard_lm``) and runs, over the ranks:

- the tiny f32 LM's ``prefill_slot`` and a 6-token ``decode_chunk_tail``,
  on the tree as it is, quantized to int8 and to packed int4 (whole, then
  split), as ``tests/test_tp_serving.py``'s sharded chunk runs;
- the tiny talker's ``talker_prefill`` and a 4-frame
  ``decode_chunk_audio``, as ``tests/test_sharded_inference.py``'s.

Rank 0 writes ``DIR/outputs.npz`` (the tokens and the audio) and
``DIR/outputs.json`` (the sums each group issued).

``... RANK WORLD PORT orphan``: rank 0 joins the groups and exits at once;
every other rank then waits for a command, as a follower does, and must
fail (exit 1) instead of waiting on.  Imports no ``jax``.
"""

import datetime
import json
import os
import sys

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
    out = {}
    for mode, tree in (("f32", lm_tree), ("int8", quantize_tree(lm_tree, min_size=0)),
                       ("int4", quantize_tree(lm_tree, min_size=0, bits=4))):
        out[f"lm_{mode}"] = lm_chunk(_tp_shard_lm(tree, cfg, lm_tp, "the tiny LM"), cfg, prompt, lm_tp)
    params = dict(tts_tree, talker=_tp_shard_lm(tts_tree["talker"], qcfg.lm, tts_tp, "the tiny talker", talker=True))
    state = decoder_lm.init_decode_state(qcfg.lm, 1, max_t=64, tp=tts_tp)
    tstate = qwen3_tts.talker_prefill(params, qcfg, text, params["speakers"][:1], state, tts_tp)
    audio, _, _, _ = qwen3_tts.decode_chunk_audio(params, qcfg, tstate, torch.zeros((0, qcfg.n_q), dtype=torch.int32),
                                                  4, tts_tp)
    out["talker_audio"] = audio.numpy()
    collectives = {name: group.collectives for name, group in runtime.groups.items()}
    runtime.shutdown()
    if rank == 0:
        np.savez(f"{out_dir}/outputs.npz", **out)
        with open(f"{out_dir}/outputs.json", "w") as f:
            json.dump({"collectives": collectives}, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), *sys.argv[5:])
