"""The comparison that decides ``correct``.

After the window has closed and the serve is gone, a sample drawn from the
seed of the requests the serve finished in the window (the longest of each
kind among them) is held against the plain reference, run at the
precision the configuration states, on weights the reference makes again
from the seed.  The numbers compared, each the worst over its sample:

- ``lm_gap``: the LM's served reply tokens, teacher-forced after their
  prompt: the reference's best logit minus the served token's;
- ``talker_gap``: the same for each served frame's code 0 (as clipped to
  the codebook);
- ``cp_gap``: the same for codes 1-15 of each served frame;
- ``audio_dist``: the served waveform of a synthesis against the
  reference's Code2Wav of its served frames, streamed as served: one
  minus their cosine similarity (random-init Code2Wav saturates most
  samples at the clip to [-1, 1], so the few that are not carry the
  difference);
- ``stt_enc_dist``: a transcription's encoder output (the log-mel
  frontend and the conformer) against the reference's encoding of the same
  audio: one minus their cosine similarity over the valid frames;
- ``stt_gap``: its served tokens against the reference's TDT joint and
  prediction network on the program's encoding, over every alignment a
  greedy decode can take (:func:`s2sbench.reference.parakeet.alignment_gap`):
  the decode is followed from the program's own encoding, and
  ``stt_enc_dist`` checks the stage that this skips;
- ``stt_edit``: its served tokens against the reference's own greedy
  decode of its own encoding: their edit distance over the longer of the
  two.

A configuration may list a number as ``reported``: printed beside the
others, not held.

With ``control`` the same inputs also go through the reference one
precision down (:data:`s2sbench.reference.nn.BELOW`), and its choices (the
token each position puts first, its waveform, its transcription) are held
against the stated reference by the same numbers.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from s2sbench import weights
from s2sbench.reference import decoder, nn, parakeet, tts

LM_MODES = {None: "bf16", "int8": "int8", "int8-dyn": "int8", "int4": "int4"}
TALKER_MODES = {None: "bf16", "int8": "int8", "int8-dyn": "int8", "int8+cp4": "int8", "int4": "int4"}
CP_MODES = {None: "bf16", "int8": "int8", "int8-dyn": "int8", "int8+cp4": "int4", "int4": "int4"}


def stated(models: dict) -> dict:
    """The precision each part of the configuration states."""
    q_lm, q_tts = models["lm"].get("quantize"), models["tts"].get("quantize")
    return {"lm": LM_MODES[q_lm], "talker": TALKER_MODES[q_tts], "cp": CP_MODES[q_tts], "parakeet": "bf16",
            "code2wav": "bf16"}


def below(prec: dict) -> dict:
    return {k: nn.BELOW[v] for k, v in prec.items()}


def edit_share(a: list[int], b: list[int]) -> float:
    """The edit distance between token lists *a* and *b* over the longer's length."""
    row = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, y in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1, prev + (x != y))
    return row[-1] / max(len(a), len(b), 1)


def sample(records: list[dict], n: int, rng: np.random.Generator, size) -> list[dict]:
    """The longest of *records* by *size*, and up to *n* - 1 others drawn by *rng*."""
    if not records:
        return []
    order = sorted(range(len(records)), key=lambda i: -size(records[i]))
    rest = order[1:]
    picked = [order[0], *(rest[i] for i in sorted(rng.choice(len(rest), min(n - 1, len(rest)), replace=False)))] \
        if rest else [order[0]]
    return [records[i] for i in picked]


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@torch.no_grad()
def judge_lm(recs: list[dict], models: dict, seed: int, device, prec: dict, control: bool) -> dict:
    c = models["lm"]
    tree = weights.make("lm", models, seed, device)
    refs, out = [], {"lm_gap": 0.0}
    details = []
    layers, head = decoder.prepare(tree, c, prec["lm"]), decoder.head(tree, c, prec["lm"])
    for rec in recs:
        ids, served = rec["ids"], rec["tokens"]
        tokens = torch.tensor(ids + served, device=device)
        logits = decoder.lm_logits(tree, layers, head, c, tokens)[len(ids) - 1:len(ids) - 1 + len(served)]
        refs.append(logits)
        gaps = logits.amax(-1) - logits.gather(-1, torch.tensor(served, device=device)[:, None])[:, 0]
        out["lm_gap"] = max(out["lm_gap"], float(gaps.max()))
        details.append({"prompt": len(ids), "tokens": len(served), "gap": float(gaps.max()),
                        "worst_at": int(gaps.argmax()), "via": rec.get("via"), "slot": rec.get("slot_id"),
                        "t": rec.get("t_rel")})
    del layers, head
    _free()
    if control:
        layers, head = decoder.prepare(tree, c, below(prec)["lm"]), decoder.head(tree, c, below(prec)["lm"])
        gap = 0.0
        for rec, ref in zip(recs, refs):
            ids, served = rec["ids"], rec["tokens"]
            tokens = torch.tensor(ids + served, device=device)
            low = decoder.lm_logits(tree, layers, head, c, tokens)[len(ids) - 1:len(ids) - 1 + len(served)]
            gap = max(gap, tts.codes_gap(ref, low.argmax(-1)))
        out["control_lm_gap"] = gap
    return out, details


@torch.no_grad()
def judge_tts(recs: list[dict], models: dict, seed: int, device, prec: dict, control: bool,
              context: int) -> dict:
    c = models["tts"]
    c2w_c = c["code2wav"]
    cb, up = c2w_c["codebook_size"], tts.upsample(c2w_c)
    tree = weights.make("tts", models, seed, device)
    out = {"talker_gap": 0.0, "cp_gap": 0.0, "audio_dist": 0.0}
    precs = [prec] + ([below(prec)] if control else [])
    kept = []
    for k, p in enumerate(precs):
        t_layers = decoder.prepare(tree["talker"], c["talker"], p["talker"])
        cp_layers = decoder.prepare(tree["cp"], c["cp"], p["cp"])
        c2w = tts.prepare_code2wav(tree["c2w"], p["code2wav"])
        for i, rec in enumerate(recs):
            served_audio = np.concatenate(rec["audio"]) if rec["audio"] else np.zeros(0, np.float32)
            n_served = len(served_audio) // up
            codes = torch.from_numpy(rec["codes"]).to(device)
            if len(codes) < n_served:
                raise ValueError(f"a synthesis served {n_served} frames but {len(codes)} were recorded")
            codes = codes[:max(n_served, 1)]
            logits0, logits_cp = tts.frame_logits(tree, t_layers, cp_layers, c, torch.from_numpy(rec["text"]).to(device),
                                                  rec["speaker"].to(device), codes)
            wav = tts.streamed_audio(c2w, c2w_c, codes, rec["chunk_sizes"], context, n_served)
            if k == 0:
                kept.append((logits0, logits_cp, wav))
                out["talker_gap"] = max(out["talker_gap"], tts.code0_gap(logits0, codes[:, 0], cb))
                out["cp_gap"] = max(out["cp_gap"], tts.codes_gap(logits_cp, codes[:, 1:]))
                served = torch.from_numpy(served_audio[:len(wav)]).to(device)
                out["audio_dist"] = max(out["audio_dist"], _cos_dist(served, wav))
            else:
                ref0, refcp, ref_wav = kept[i]
                out["control_talker_gap"] = max(out.get("control_talker_gap", 0.0),
                                                tts.code0_gap(ref0, torch.clamp(logits0.argmax(1), max=cb - 1), cb))
                out["control_cp_gap"] = max(out.get("control_cp_gap", 0.0), tts.codes_gap(refcp, logits_cp.argmax(-1)))
                out["control_audio_dist"] = max(out.get("control_audio_dist", 0.0), _cos_dist(wav, ref_wav))
        del t_layers, cp_layers, c2w
        _free()
    return out


def _cos_dist(x: torch.Tensor, ref: torch.Tensor) -> float:
    """1 - cos(x, ref) over their common length (1 where one is silent)."""
    n = min(len(x), len(ref))
    x, ref = x[:n].double(), ref[:n].double()
    norms = torch.linalg.vector_norm(x) * torch.linalg.vector_norm(ref)
    return float(1.0 - (x @ ref) / norms) if n and norms > 0 else 1.0


@torch.no_grad()
def judge_stt(recs: list[dict], models: dict, seed: int, device, prec: dict, control: bool) -> dict:
    c = models["parakeet"]
    tree = weights.make("parakeet", models, seed, device)
    out = {"stt_enc_dist": 0.0, "stt_gap": 0.0, "stt_edit": 0.0}
    low = below(prec)["parakeet"]
    for rec in recs:
        ref, enc_len = parakeet.encoding(tree, c, rec["audio"], rec["n_valid"], prec["parakeet"], device)
        served = rec["enc"].to(device).float()[:enc_len]
        out["stt_enc_dist"] = max(out["stt_enc_dist"], _cos_dist(served.reshape(-1), ref[:enc_len].reshape(-1)))
        gap = parakeet.alignment_gap(tree, c, served, enc_len, rec["tokens"], prec["parakeet"])
        out["stt_gap"] = max(out["stt_gap"], gap)
        ref_tokens = parakeet.decode(tree, c, ref, enc_len, prec["parakeet"])
        out["stt_edit"] = max(out["stt_edit"], edit_share(rec["tokens"], ref_tokens))
        if control:
            enc_low, _ = parakeet.encoding(tree, c, rec["audio"], rec["n_valid"], low, device)
            out["control_stt_enc_dist"] = max(out.get("control_stt_enc_dist", 0.0),
                                              _cos_dist(enc_low[:enc_len].reshape(-1), ref[:enc_len].reshape(-1)))
            tokens = parakeet.decode(tree, c, enc_low, enc_len, low)
            gap_low = parakeet.alignment_gap(tree, c, enc_low, enc_len, tokens, prec["parakeet"])
            out["control_stt_gap"] = max(out.get("control_stt_gap", 0.0), gap_low)
            out["control_stt_edit"] = max(out.get("control_stt_edit", 0.0), edit_share(tokens, ref_tokens))
    return out


def judge(rec, models: dict, seed: int, device, t0: float, context: int, n_sample: int = 6,
          n_lm: int = 24, control: bool = False) -> dict:
    """Every number compared (and with *control* the control's), from the
    recorded requests that started at or after *t0* and finished: up to
    *n_lm* LM generations (short replies, so nearly all of them), and up
    to *n_sample* syntheses and transcriptions."""
    nn.f32_numerics()
    prec = stated(models)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), 7]))

    def done(records, has):
        return [r for r in records if r["finished"] and r["t"] >= t0 and has(r)]

    lm = sample(done(rec.lm, lambda r: r["tokens"]), n_lm, rng, lambda r: len(r["tokens"]))
    for r in lm:
        r["t_rel"] = round(r["t"] - t0, 3)
    synth = sample(done(rec.tts, lambda r: r["audio"] and r["text"] is not None), n_sample, rng,
                   lambda r: sum(len(a) for a in r["audio"]))
    stt = sample(done(rec.stt, lambda r: r["enc"] is not None), n_sample, rng, lambda r: r["n_valid"])
    numbers: dict = {}
    counts = {"lm": len(lm), "tts": len(synth), "stt": len(stt),
              "lm_tokens": sum(len(r["tokens"]) for r in lm),
              "tts_frames": sum(sum(len(a) for a in r["audio"]) for r in synth) // tts.upsample(
                  models["tts"]["code2wav"])}
    records = {}
    if lm:
        lm_numbers, records["lm"] = judge_lm(lm, models, seed, device, prec, control)
        numbers.update(lm_numbers)
        _free()
    if synth:
        numbers.update(judge_tts(synth, models, seed, device, prec, control, context))
        _free()
    if stt:
        numbers.update(judge_stt(stt, models, seed, device, prec, control))
        _free()
    counts["finished"] = {"lm": sum(r["finished"] for r in rec.lm), "tts": sum(r["finished"] for r in rec.tts),
                          "stt": len(rec.stt)}
    counts["recorded"] = {"lm": len(rec.lm), "tts": len(rec.tts)}
    return {"numbers": numbers, "sampled": counts, "records": records}
