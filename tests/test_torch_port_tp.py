"""Tensor-parallel serving of the port (``--model_parallel``) on the CPU, two
ranks over gloo, held against the JAX package's sharded serving path.

Two ranks run as processes: ``tests/torch_port_tp_worker.py`` (spawned once
for the file, on a free port, with a time limit of their own) for the
programs, and the builder's own follower (``builder.launch_tp``, on the
layout ``TPLayout(("cpu", "cpu"), "gloo")``) for the registry-built engines
and the serve.  The weights are the JAX package's tiny trees (from
``jax.random`` keys), carried across by ``s2s_tpu_torch.weights``.  Checked:

- the flag parses; too few devices raise (``mesh.tp_layout`` and the CLI
  build); heads that the ranks do not divide raise before any rank starts,
  naming the model; ``int8-dyn`` on a split tree raises;
- ``mesh.local_shard`` of the port's tree is bit-equal, leaf by leaf, to
  ``np.split`` of the JAX tree on the axes ``param_shardings`` names, for
  bf16 and int8 trees (payloads and every scale, a column-parallel weight's
  scales split with its columns); the int8 tree quantized whole equals
  JAX's quantize of the tree sharded on a (1, 2) mesh; a row-parallel
  packed int4 shard unpacks to exactly the slice of JAX's unpacked values;
- every tail program at one rank with a counting group issues no
  collective and returns what it returns without the group;
- over two ranks, the tiny f32 LM's prefill and tail chunk are token-exact
  against JAX's single-device programs in f32, int8 and int4, and the tiny
  talker's prefill and 4-frame chunk within 2e-3 of JAX's
  (``tests/test_sharded_inference.py``'s bound);
- engines built by the registry with ``--model_parallel 2`` (warm-up run
  and mirrored) are token-equal to the port's one-rank engines and to the
  JAX registry's, and their audio equal to both within 2e-3; the follower's
  replicated state equals the leader's, and each rank's caches hold its kv
  heads of the one-rank engine's caches (per layer and head sums, 1e-5);
- a voice turn through the WebSocket at ``--model_parallel 2`` with the
  JAX test's seams (an energy VAD and a fixed transcript,
  ``tests/test_tp_serving.py``) is answered with audio;
- after the serve stops, the follower has exited 0, its groups and the
  leader's are shut down, and the process has no process group of world
  size above 1; a follower whose leader is gone exits non-zero at once.
"""

import asyncio
import base64
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from s2s_tpu.models import decoder_lm as jdl  # noqa: E402
from s2s_tpu.models import qwen3_tts as jq  # noqa: E402
from s2s_tpu.ops import quant as jquant  # noqa: E402
from s2s_tpu.parallel import batched_decode as jbd  # noqa: E402
from s2s_tpu.parallel import mesh as jmesh  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import decoder_lm as tdl  # noqa: E402
from s2s_tpu_torch.models import qwen3_tts as tq  # noqa: E402
from s2s_tpu_torch.ops import int4_matmul as tm4  # noqa: E402
from s2s_tpu_torch.ops.quant import QUANT_TYPES, quantize_tree  # noqa: E402
from s2s_tpu_torch.parallel import batched_decode as tbd  # noqa: E402
from s2s_tpu_torch.parallel import mesh  # noqa: E402
from s2s_tpu_torch.tools.convert_checkpoint import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_port_tp_worker.py")
WORLD = 2
TIME_LIMIT_S = 60
TALKER_ATOL = 2e-3
TWO_CPU_RANKS = mesh.TPLayout(("cpu", "cpu"), "gloo")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The file's tiny programs on one thread: its ranks and engines share
    the host with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees():
    """The JAX tiny LM and talker trees, a prompt and a text (numpy)."""
    cfg = jdl.DecoderLMConfig.tiny()
    qcfg = jq.Qwen3TTSConfig.tiny()
    rng = np.random.default_rng(16)
    return {"cfg": cfg, "qcfg": qcfg, "tcfg": tdl.DecoderLMConfig.tiny(), "tqcfg": tq.Qwen3TTSConfig.tiny(),
            "lm": jdl.init_params(jax.random.PRNGKey(0), cfg),
            "tts": jq.init_params(jax.random.PRNGKey(4), qcfg),
            "prompt": rng.integers(1, cfg.vocab_size, (1, 16)).astype(np.int32),
            "text": np.asarray([[3, 7, 11, 0, 0, 0, 0, 0]], np.int32)}


# ── flags and errors ─────────────────────────────────────────────────

#: the JAX test's two-unit CLI (``tests/test_tp_serving.py``), with the
#: port's energy VAD on 127.0.0.1
FLAGS = [
    "--host", "127.0.0.1", "--port", "0", "--vad_backend", "energy", "--vad_smart_turn", "false",
    "--vad_min_silence_ms", "64",
    "--stt", "whisper", "--stt_model_size", "tiny",
    "--llm_backend", "local-jax", "--llm_model_size", "tiny",
    "--llm_batched_slots", "2", "--llm_max_new_tokens", "8",
    "--tts", "qwen3", "--tts_model_size", "tiny", "--tts_batched_slots", "2",
    "--tts_streaming_chunk_size", "4", "--tts_max_new_tokens", "8",
]


def test_model_parallel_flag_parses():
    from s2s_tpu_torch.arguments import parse_arguments

    assert parse_arguments(["--model_parallel", "2"]).module.model_parallel == 2
    assert parse_arguments([]).module.model_parallel == 1


@pytest.mark.parametrize("where", ["layout", "cli"])
def test_too_few_devices_raise(where):
    from s2s_tpu_torch import cli

    if where == "layout":
        visible = torch.cuda.device_count()
        with pytest.raises(RuntimeError, match=f"--model_parallel 64 needs 64 devices; {visible} visible"):
            mesh.tp_layout(64, torch.device("cuda"))
    else:
        with pytest.raises(RuntimeError, match="--model_parallel 2 needs 2 devices; 1 visible"):
            cli.build_from_argv(["--device", "cpu", *FLAGS, "--model_parallel", "2"], threading.Event())
    assert not dist.is_initialized()


def test_heads_the_ranks_do_not_divide_raise_before_any_rank_starts():
    from s2s_tpu_torch import cli

    # the tiny LM has 4 query and 2 kv heads
    with pytest.raises(ValueError, match="--llm_model_size tiny has 4 query and 2 kv heads, which 4 ranks"):
        cli.build_from_argv(["--device", "cpu", *FLAGS, "--model_parallel", "4"], threading.Event(),
                            tp_layout=mesh.TPLayout(("cpu",) * 4, "gloo"))


@pytest.mark.parametrize("flag", ["--llm_quantize", "--tts_quantize"])
def test_int8_dyn_on_a_split_tree_raises(flag):
    from s2s_tpu_torch import cli

    with pytest.raises(ValueError, match=f"{flag} int8-dyn with --model_parallel 2"):
        cli.build_from_argv(["--device", "cpu", *FLAGS, flag, "int8-dyn", "--model_parallel", "2"],
                            threading.Event(), tp_layout=TWO_CPU_RANKS)


def test_sampled_decode_under_tensor_parallelism_raises():
    from s2s_tpu_torch import cli

    with pytest.raises(ValueError, match="--model_parallel 2: sampled decode"):
        cli.build_from_argv(["--device", "cpu", *FLAGS, "--llm_gen_temperature", "0.7", "--model_parallel", "2"],
                            threading.Event(), tp_layout=TWO_CPU_RANKS)


# ── shards against the JAX tree ──────────────────────────────────────


def _model_axis(spec) -> int | None:
    return next((d for d, part in enumerate(spec) if part == "model"), None)


def _bits(x) -> np.ndarray:
    """The bytes of an array or tensor, for bit equality (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    arr = np.asarray(x)
    return arr.view(np.uint8) if arr.dtype.itemsize else arr


def _jax_split(arr, axis: int | None, rank: int):
    arr = np.asarray(arr)
    return arr if axis is None else np.split(arr, WORLD, axis=axis)[rank]


@pytest.mark.parametrize("rank", range(WORLD))
def test_bf16_shards_equal_np_split_of_the_jax_tree(trees, rank):
    cfg = dataclasses.replace(trees["cfg"], dtype=jnp.bfloat16)
    jp = jdl.init_params(jax.random.PRNGKey(1), cfg)
    specs = _flat(jdl.param_shardings(cfg))
    shard = _flat(mesh.local_shard(weights.tree_to_torch(jp, "cpu"), tdl.param_shardings(trees["cfg"]), rank, WORLD))
    want = _flat(jp)
    assert set(shard) == set(want) == set(specs)
    for key, leaf in shard.items():
        assert leaf.dtype == torch.bfloat16, key
        assert np.array_equal(_bits(leaf), _bits(_jax_split(want[key], _model_axis(specs[key]), rank))), key


@pytest.mark.parametrize("rank", range(WORLD))
def test_int8_shards_equal_np_split_and_jax_shard_then_quantize(trees, rank):
    """The port quantizes the whole tree, then takes the rank's shard; JAX's
    registry shards, then quantizes (each scale's absmax then spans the
    whole input dim through XLA's collectives): the same bits."""
    cfg, jp = trees["cfg"], trees["lm"]
    whole = jquant.quantize_tree(jp, min_size=0)
    jmesh_ = jmesh.make_mesh(jax.devices()[:WORLD], data=1, model=WORLD)
    sharded_then = jquant.quantize_tree(jmesh.shard_params(jp, jdl.param_shardings(cfg), jmesh_), min_size=0)
    specs = _flat(jdl.param_shardings(cfg))
    port = quantize_tree(weights.tree_to_torch(jp, "cpu"), min_size=0)
    shard = _flat(mesh.local_shard(port, tdl.param_shardings(cfg), rank, WORLD))
    quantized = 0
    for key, leaf in shard.items():
        want, then = _flat(whole)[key], _flat(sharded_then)[key]
        axis = _model_axis(specs[key])
        if isinstance(leaf, QUANT_TYPES):
            quantized += 1
            q_axis = axis
            scale_axis = None if axis is None or axis == want.q.ndim - 2 else want.scale.ndim - 1
            for got, a, b, ax in ((leaf.q, want.q, then.q, q_axis), (leaf.scale, want.scale, then.scale, scale_axis)):
                assert np.array_equal(_bits(a), _bits(np.asarray(b))), key  # whole == shard-then-quantize
                assert np.array_equal(_bits(got), _bits(_jax_split(a, ax, rank))), key
        else:
            assert np.array_equal(_bits(leaf), _bits(_jax_split(want, axis, rank))), key
    assert quantized == 7  # wq wk wv wo w_gate w_up w_down


def test_int4_row_parallel_shards_unpack_to_the_jax_slice(trees):
    """A packed byte holds rows k and k + K/2: wo and w_down (split on their
    input dim) are unpacked, sliced and re-packed per rank; the
    column-parallel payloads keep their bytes."""
    cfg, jp = trees["cfg"], trees["lm"]
    jq4 = _flat(jquant.quantize_tree(jp, min_size=0, bits=4))
    specs = _flat(jdl.param_shardings(cfg))
    port = quantize_tree(weights.tree_to_torch(jp, "cpu"), min_size=0, bits=4)

    def unpack(packed) -> np.ndarray:
        lo, hi = tm4.unpack_nibbles(torch.from_numpy(np.array(packed)))
        return torch.cat([lo, hi], dim=-2).numpy()

    for rank in range(WORLD):
        shard = _flat(mesh.local_shard(port, tdl.param_shardings(cfg), rank, WORLD))
        for name in ("wo", "w_down", "wq", "w_up"):
            key = f"layers/{name}"
            got, want, axis = shard[key], jq4[key], _model_axis(specs[key])
            if axis == want.q_packed.ndim - 2:  # row-parallel
                assert np.array_equal(unpack(got.q_packed), _jax_split(unpack(want.q_packed), axis, rank)), key
                assert np.array_equal(_bits(got.scale), _bits(np.asarray(want.scale))), key
            else:
                assert np.array_equal(_bits(got.q_packed), _bits(_jax_split(want.q_packed, axis, rank))), key
                assert np.array_equal(_bits(got.scale), _bits(_jax_split(want.scale, 1, rank))), key


# ── one rank: a counting group issues nothing ────────────────────────


class CountingGroup:
    """A tensor-parallel group of one rank that counts what it is asked."""

    rank, size = 0, 1

    def __init__(self) -> None:
        self.calls = 0

    def all_reduce(self, t):
        self.calls += 1
        return t

    def gather_last(self, local, full):
        self.calls += 1
        return local


def _lm_programs(params, cfg, prompt, tp) -> list[torch.Tensor]:
    state = tbd.init_multi_state(cfg, 2, max_t=64, tp=tp)
    tok, state = tbd.prefill_slot(params, cfg, prompt, 12, state, 0, tp)
    out = [tok]
    out += tbd.prefill_and_chunk_slot_tail(params, cfg, prompt, 10, state, 1, 4, -1, tp)[:3]
    out += tbd.decode_chunk_slot_tail(params, cfg, tok, state, 3, -1, 0, tp)[:3]
    tokens = torch.stack([tok, out[-1]])
    out += tbd.decode_chunk_gathered_tail(params, cfg, tokens, state, 5, -1, torch.tensor([0, 1]), tp)[:3]
    out += tbd.decode_chunk_tail(params, cfg, tokens, state, 2, -1, torch.tensor([True, False]), tp)[:3]
    return out + [state.caches.k, state.caches.v, state.pos]


def _talker_programs(params, qcfg, text, tp) -> list[torch.Tensor]:
    spk = params["speakers"][:1]
    single = tq.talker_prefill(params, qcfg, text, spk, tdl.init_decode_state(qcfg.lm, 1, max_t=64, tp=tp), tp)
    out = list(tq.decode_chunk_audio(params, qcfg, single, torch.zeros((0, qcfg.n_q), dtype=torch.int32), 2, tp)[:2])
    state = tbd.init_multi_state(qcfg.lm, 2, max_t=64, tp=tp)
    contexts = torch.zeros((2, 4, qcfg.n_q), dtype=torch.int32)
    bos, state = tq.prefill_tts_slot(params, qcfg, text, spk, state, 1, tp)
    audio, eos, emb, state, contexts = tq.prefill_and_first_chunk_slot_tail(params, qcfg, text, spk, state, contexts,
                                                                            2, 0, tp)
    out += [bos, audio, eos, emb]
    out += tq.decode_chunk_audio_slot_tail(params, qcfg, emb, state, contexts[0], 2, 0, tp)[:3]
    embeds = torch.stack([emb, bos])
    out += tq.decode_chunk_audio_gathered_tail(params, qcfg, embeds, state, contexts, 3, torch.tensor([0, 1]), tp)[:3]
    return out + [state.caches.k, state.pos, contexts]


@pytest.mark.parametrize("model", ["lm", "talker"])
def test_one_rank_with_a_counting_group_issues_no_collective(trees, model):
    group = CountingGroup()
    if model == "lm":
        params = quantize_tree(weights.tree_to_torch(trees["lm"], "cpu"), min_size=0)
        prompt = torch.from_numpy(trees["prompt"])
        want = _lm_programs(params, trees["tcfg"], prompt, None)
        got = _lm_programs(params, trees["tcfg"], prompt, group)
    else:
        params = weights.qwen3_tts_params(trees["tts"], "cpu")
        text = torch.from_numpy(trees["text"])
        want = _talker_programs(params, trees["tqcfg"], text, None)
        got = _talker_programs(params, trees["tqcfg"], text, group)
    assert group.calls == 0
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


# ── two ranks: the programs against the JAX package ──────────────────


@pytest.fixture(scope="module")
def tp_run(trees, tmp_path_factory):
    """The worker ranks' results (rank 0's files), run once for the file."""
    out = tmp_path_factory.mktemp("tp")
    cfg = trees["cfg"]
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}
    arrays = {**{f"lm/{k}": v for k, v in flatten(trees["lm"]).items()},
              **{f"tts/{k}": v for k, v in flatten(trees["tts"]).items()}}
    np.savez(out / "inputs.npz", lm_cfg=json.dumps(fields), prompt=trees["prompt"], text=trees["text"], **arrays)
    port = _free_port()
    # one thread a rank: the ranks share the host with the other test workers
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(out), str(rank), str(WORLD), str(port)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(WORLD)]
    deadline = time.monotonic() + TIME_LIMIT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    result = json.loads((out / "outputs.json").read_text())
    result["arrays"] = dict(np.load(out / "outputs.npz"))
    return result


def _jax_chunk(p, cfg, prompt) -> np.ndarray:
    """``tests/test_tp_serving.py``'s chunk on one device: slot 0's prefill,
    then 6 tail steps with slot 1 idle."""
    state = jbd.init_multi_state(cfg, 2, max_t=64)
    tok, state = jbd.prefill_slot(p, cfg, jnp.asarray(prompt), jnp.asarray(12, jnp.int32), state,
                                  jnp.asarray(0, jnp.int32))
    tokens = jnp.zeros((2,), jnp.int32).at[0].set(tok)
    toks, _em, _tok, _state, _act = jbd.decode_chunk_tail(p, cfg, tokens, state, 6, -1, jnp.asarray([True, False]))
    return np.asarray(toks[:, 0])


@pytest.mark.parametrize("mode", ["f32", "int8", "int4"])
def test_two_rank_lm_chunk_is_token_exact_against_jax(trees, tp_run, mode):
    cfg, jp = trees["cfg"], trees["lm"]
    if mode != "f32":
        jp = jquant.quantize_tree(jp, min_size=0, bits=4 if mode == "int4" else 8)
    want = _jax_chunk(jp, cfg, trees["prompt"])
    got = tp_run["arrays"][f"lm_{mode}"]
    assert np.array_equal(got, want), (got, want)
    # every chunk step summed wo's and w_down's partials on both layers, the embedding and the logits
    assert tp_run["collectives"]["lm"] == 3 * (1 + 6) * (2 * cfg.n_layers + 2)


def test_two_rank_talker_chunk_is_within_2e_3_of_jax(trees, tp_run):
    qcfg, jp = trees["qcfg"], trees["tts"]
    state = jdl.init_decode_state(qcfg.lm, 1, max_t=64)
    tstate = jq.talker_prefill(jp, qcfg, jnp.asarray(trees["text"]), jp["speakers"][jnp.asarray([0])], state)
    audio, _eos, _tstate, _ctx = jq.decode_chunk_audio(jp, qcfg, tstate, jnp.zeros((0, qcfg.n_q), jnp.int32), 4)
    want = np.asarray(audio)
    got = tp_run["arrays"]["talker_audio"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TALKER_ATOL)
    # the talker's blocks only: its codec embedding and head are whole on every rank
    assert tp_run["collectives"]["tts"] == (1 + 4) * 2 * qcfg.lm.n_layers


# ── the registry's engines and the serve ─────────────────────────────


@pytest.fixture(scope="module")
def checkpoints(trees, tmp_path_factory):
    """The JAX trees as converted checkpoints, so that both packages'
    registries serve the same weights."""
    out = tmp_path_factory.mktemp("tp_ckpt")
    paths = {"lm": str(out / "lm.npz"), "tts": str(out / "tts.npz")}
    for name, path in paths.items():
        np.savez(path, **flatten(trees[name]))
    return ["--llm_checkpoint", paths["lm"], "--tts_checkpoint", paths["tts"]]


ENGINE_PROMPT = [3, 5, 7, 11, 2]


def _engine_calls(lm, tts, spk):
    text = np.zeros((1, 16), np.int32)
    text[0, :5] = [3, 5, 7, 9, 11]
    toks = list(lm.generate(ENGINE_PROMPT, max_new=8))
    audio = np.concatenate([c for c, _ in tts.stream(text, spk, 6)])
    return toks, audio


class _OneThreadFollowers:
    """The builder's follower processes started in the block run one
    thread each: the ranks share the host with the other test workers."""

    def __enter__(self):
        self._old = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"

    def __exit__(self, *exc):
        if self._old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = self._old


def _port_engines(server):
    unit = server.pool[0]
    lm = next(h for h in unit.handlers if type(h).__name__ == "LocalTorchLLMHandler").shared_lm
    tts = next(h for h in unit.handlers if type(h).__name__ == "Qwen3TTSHandler").shared_tts
    return lm, tts


@pytest.fixture(scope="module")
def engines(checkpoints):
    """The same calls on the port's registry engines at two ranks (warm-up
    mirrored) and at one, and on the JAX registry's engines."""
    from s2s_tpu_torch import builder, cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    argv = ["--device", "cpu", *FLAGS, *checkpoints, "--warmup_engines", "true"]
    out = {}
    for label, extra, layout in (("two", ["--model_parallel", "2"], TWO_CPU_RANKS), ("one", [], None)):
        stop = threading.Event()
        with _OneThreadFollowers():
            manager, server, _ = cli.build_from_argv([*argv, *extra], stop, tp_layout=layout)
        try:
            lm, tts = _port_engines(server)
            handler = next(h for h in server.pool[0].handlers if type(h).__name__ == "LocalTorchLLMHandler")
            out[f"{label}_lm_weights"] = {"handler": handler.params is not None,
                                          "engine_embed_rows": lm.params["embed"].shape[0]}
            out[label] = _engine_calls(lm, tts, tts.params["speakers"][:1])
            handler = builder.tp_handler_of(manager)
            if handler is not None:
                handler.close()
                out["runtime"] = handler.runtime
            out[f"{label}_summary"] = {"lm": lm.state_summary(), "tts": tts.state_summary()}
        finally:
            stop.set()
            manager.stop()
            GLOBAL_MODEL_CACHE.clear()

    from s2s_tpu.arguments import parse_arguments
    from s2s_tpu.builder import build_pipeline_unit
    from s2s_tpu.registry import GLOBAL_MODEL_CACHE as JAX_CACHE

    JAX_CACHE.clear()
    unit = build_pipeline_unit(0, parse_arguments([*FLAGS, *checkpoints]), threading.Event())
    lm = next(h for h in unit.handlers if type(h).__name__ == "LocalJAXLLMHandler").shared_lm
    tts = next(h for h in unit.handlers if type(h).__name__ == "Qwen3TTSHandler").shared_tts
    try:
        out["jax"] = _engine_calls(lm, tts, tts.params["speakers"][jnp.asarray([0])])
    finally:
        JAX_CACHE.clear()
    return out


def test_registry_engines_at_two_ranks_match_one_rank_and_jax(engines):
    toks, audio = engines["two"]
    assert len(toks) > 0 and toks == engines["one"][0] == engines["jax"][0], engines
    for other in ("one", "jax"):
        assert audio.shape == engines[other][1].shape, other
        np.testing.assert_allclose(audio, engines[other][1], atol=TALKER_ATOL)


def test_the_leader_keeps_only_its_shard_of_the_lm(engines, trees):
    """Under tensor parallelism no rank keeps the whole LM: the leader's
    handler holds no tree, its engine the rank's vocabulary rows."""
    vocab = trees["cfg"].vocab_size
    assert engines["two_lm_weights"] == {"handler": False, "engine_embed_rows": vocab // WORLD}
    assert engines["one_lm_weights"] == {"handler": True, "engine_embed_rows": vocab}


def test_followers_state_equals_the_leaders(engines):
    """The follower's replicated state (positions, next tokens or
    embeddings and contexts) is the leader's bit for bit; each rank's
    caches hold its kv heads of the one-rank engine's."""
    runtime = engines["runtime"]
    assert runtime.consistent() == {"lm": True, "tts": True}
    follower = {name: runtime.follower_summaries[name][1] for name in ("lm", "tts")}
    for name in ("lm", "tts"):
        one = np.asarray(engines["one_summary"][name]["cache_sums"])  # (k|v, layers, kv heads)
        heads = one.shape[-1] // WORLD
        for rank, summary in ((0, engines["two_summary"][name]), (1, follower[name])):
            got = np.asarray(summary["cache_sums"])
            np.testing.assert_allclose(got, one[..., rank * heads : (rank + 1) * heads], rtol=1e-5)
    for name in ("int8_matmul", "decode_attention"):
        assert runtime.follower_reports[1]["launches"][name] == 0  # the CPU takes the plain versions


@pytest.fixture(scope="module")
def served(checkpoints):
    """A voice turn through the WebSocket at --model_parallel 2, with the
    JAX test's seams: an energy VAD and a fixed transcript."""
    from s2s_tpu_torch import builder, cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE
    from s2s_tpu_torch.stt.progressive import DecodeResult
    from s2s_tpu_torch.stt.whisper_handler import WhisperSTTHandler

    real = WhisperSTTHandler._build_transcriber
    WhisperSTTHandler._build_transcriber = lambda self, *a: (lambda audio: DecodeResult("hello there",
                                                                                        language_code="en"))
    stop = threading.Event()
    try:
        with _OneThreadFollowers():
            manager, server, _ = cli.build_from_argv(["--device", "cpu", *FLAGS, *checkpoints, "--model_parallel",
                                                      "2"], stop, tp_layout=TWO_CPU_RANKS)
    finally:
        WhisperSTTHandler._build_transcriber = real
    handler = builder.tp_handler_of(manager)
    follower = handler.runtime.procs[0]
    manager.start()
    try:
        assert server.started.wait(30)
        events = asyncio.run(_voice_turn(f"ws://127.0.0.1:{server.bound_port}/v1/realtime", 60.0))
    finally:
        stop.set()
        manager.stop()
        assert handler.closed.wait(60)
        GLOBAL_MODEL_CACHE.clear()
    return {"events": events, "runtime": handler.runtime, "follower": follower}


async def _voice_turn(url: str, max_s: float) -> list[dict]:
    """1.5 s of a 440 Hz tone and 0.8 s of silence as PCM16 appends (the JAX
    test's WAV), then events until ``response.done``."""
    import websockets.asyncio.client as ws_client

    rate = 16_000
    t = np.arange(int(1.5 * rate)) / rate
    pcm = np.concatenate([0.4 * np.sin(2 * np.pi * 440 * t), np.zeros(int(0.8 * rate))])
    pcm16 = (pcm * 32767).astype(np.int16).tobytes()
    step = rate // 10 * 2
    events: list[dict] = []
    loop = asyncio.get_running_loop()
    async with ws_client.connect(url, max_size=None) as ws:
        events.append(json.loads(await asyncio.wait_for(ws.recv(), 10)))
        for i in range(0, len(pcm16), step):
            await ws.send(json.dumps({"type": "input_audio_buffer.append",
                                      "audio": base64.b64encode(pcm16[i : i + step]).decode()}))
        deadline = loop.time() + max_s
        while loop.time() < deadline:
            try:
                event = json.loads(await asyncio.wait_for(ws.recv(), 1.0))
            except asyncio.TimeoutError:
                continue
            events.append(event)
            if event["type"] == "response.done":
                break
    return events


def test_voice_turn_at_two_ranks_is_answered(served):
    events = served["events"]
    types = [e["type"] for e in events]
    transcripts = [e["transcript"] for e in events
                   if e["type"] == "conversation.item.input_audio_transcription.completed"]
    assert transcripts == ["hello there"], types
    deltas = [e for e in events if e["type"] == "response.output_audio.delta"]
    assert deltas and sum(len(base64.b64decode(e["delta"])) for e in deltas) > 0, types
    assert events[-1]["type"] == "response.done" and events[-1]["response"]["status"] == "completed", types
    assert served["runtime"].consistent() == {"lm": True, "tts": True}


def test_a_follower_whose_leader_is_gone_exits_non_zero(tmp_path):
    """Rank 0 joins the groups and exits; the follower, waiting for a
    command, fails at once (its connection closes) instead of lingering
    until the groups' 60 s timeout."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(tmp_path), str(rank), str(WORLD), str(port), "orphan"],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(WORLD)]
    try:
        codes = [p.wait(timeout=TIME_LIMIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    assert codes == [0, 1], logs
    assert "follower failed" in logs[1], logs


def test_shutdown_leaves_no_group_and_no_follower(served):
    runtime = served["runtime"]
    assert served["follower"].returncode == 0
    assert runtime.groups == {} and runtime.procs == []
    assert not dist.is_initialized() or dist.get_world_size() == 1
