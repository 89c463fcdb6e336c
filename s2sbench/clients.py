"""The traffic's WebSocket clients, run in a process of their own.

``python -m s2sbench.clients`` reads one JSON line on standard input (the
server's URL, the mix, the seed, the window's seconds) and runs every
session of the mix as a closed loop over the OpenAI-Realtime protocol, as a
user's client does.  Each session's first ``warmup_turns`` turns are
warm-up; the window opens when the last session's last warm-up turn
brings its first audio (or ends without any) and lasts the given
seconds: from then on every session is in its loop, streaming.  A
voice turn's request is the send of the chunk that holds its last voiced
sample, a text turn's the send of ``response.create``.  After the window
no session starts a turn, and every turn in flight runs to its end, up
to the turn limit.

Standard output carries JSON lines: ``{"window": [t0, t1]}`` when the
window opens (times of ``time.monotonic``, which every process of the
machine shares), then ``{"result": ...}`` with every turn's event times.
"""

from __future__ import annotations

import asyncio
import base64
import json
import sys
import time

import numpy as np

from s2sbench import nojax
from s2sbench.traffic import Plan

#: output PCM16 rate unless the session says otherwise
OUT_RATE = 24000


class Shared:
    def __init__(self, n: int, seconds: float) -> None:
        self.n, self.seconds = n, seconds
        self.warm = 0
        self.t0: float | None = None
        self.t1: float | None = None

    def warmed(self) -> None:
        self.warm += 1
        if self.warm == self.n:
            self.t0 = time.monotonic()
            self.t1 = self.t0 + self.seconds
            print(json.dumps({"window": [self.t0, self.t1]}), flush=True)

    def closed(self) -> bool:
        return self.t1 is not None and time.monotonic() >= self.t1


def _stamp(turn: dict, key: str, now: float) -> None:
    if turn.get(key) is None:
        turn[key] = now


async def run_session(i: int, plan: Plan, url: str, shared: Shared, out: list) -> None:
    import websockets.asyncio.client as ws_client

    mix = plan.mix
    warmup, limit = mix["warmup_turns"], mix["turn_limit_s"]
    record = {"session": i, "turns": [], "error": None}
    out.append(record)
    current: dict = {}
    done = asyncio.Event()
    rate = [OUT_RATE]
    chunk = int(mix.get("sample_rate", 16000) * mix.get("chunk_ms", 32) / 1000)
    silence = np.zeros(chunk, np.int16)
    warmed = [False]

    def warm() -> None:
        if not warmed[0]:
            warmed[0] = True
            shared.warmed()

    async def pump(ws) -> None:
        async for raw in ws:
            evt = json.loads(raw)
            now = time.monotonic()
            et = evt.get("type", "")
            turn = current.get("turn")
            if et == "session.created":
                fmt = evt.get("session", {}).get("audio", {}).get("output", {}).get("format", {})
                rate[0] = int(fmt.get("rate") or OUT_RATE)
            if turn is None:
                continue
            if et == "response.output_audio.delta":
                n = len(base64.b64decode(evt.get("delta", ""))) // 2
                turn["audio"].append((now, n))
                _stamp(turn, "t_first_audio", now)
                if turn["warmup"] and turn["index"] == warmup - 1:
                    warm()
            elif et == "input_audio_buffer.speech_stopped":
                _stamp(turn, "t_speech_stopped", now)
            elif et == "conversation.item.input_audio_transcription.completed":
                _stamp(turn, "t_transcribed", now)
            elif et == "response.output_audio_transcript.delta":
                _stamp(turn, "t_first_text", now)
            elif et == "response.created":
                _stamp(turn, "t_response_created", now)
            elif et == "error":
                turn["errors"].append(str(evt.get("error", {}).get("message", evt))[:200])
            elif et == "response.done":
                response = evt.get("response", {})
                turn["t_done"] = now
                turn["status"] = response.get("status")
                turn["usage"] = response.get("usage")
                done.set()

    async def send_pcm(ws, pcm: np.ndarray) -> None:
        await ws.send(json.dumps({"type": "input_audio_buffer.append",
                                  "audio": base64.b64encode(pcm.tobytes()).decode()}))

    async def paced(ws, until) -> None:
        """Stream silence at real time while *until()* is false (the mic stays open)."""
        step = chunk / mix["sample_rate"]
        nxt = time.monotonic()
        while not until():
            await send_pcm(ws, silence)
            nxt += step
            await asyncio.sleep(max(0.0, nxt - time.monotonic()))

    try:
        async with ws_client.connect(url, max_size=2 ** 24, open_timeout=60) as ws:
            pump_task = asyncio.create_task(pump(ws))
            await ws.send(json.dumps({"type": "session.update",
                                      "session": {"instructions": mix["instructions"]}}))
            voice = mix["kind"] == "voice"
            t_start = time.monotonic() + plan.start_offsets[i]
            if voice:
                await paced(ws, lambda: time.monotonic() >= t_start)
            else:
                await asyncio.sleep(max(0.0, t_start - time.monotonic()))
            k = 0
            while not (k >= warmup and shared.closed()):
                spec = plan.turn(i, k)
                turn = {"session": i, "index": k, "warmup": k < warmup, "kind": spec.kind,
                        "reply_tokens": spec.reply_tokens, "tone_s": spec.tone_s, "text": spec.text,
                        "audio": [], "errors": [], "t_req": None, "t_done": None, "status": None,
                        "usage": None, "rate": rate[0]}
                done.clear()
                current["turn"] = turn
                await ws.send(json.dumps({"type": "session.update",
                                          "session": {"max_output_tokens": spec.reply_tokens}}))
                if voice:
                    pcm, speech_end = plan.utterance(spec)
                    step = chunk / mix["sample_rate"]
                    nxt = time.monotonic()
                    for s in range(0, len(pcm), chunk):
                        if turn["t_req"] is None and shared.closed() and not turn["warmup"]:
                            break  # the window closed before this turn's request: it is not measured
                        await send_pcm(ws, pcm[s:s + chunk])
                        if turn["t_req"] is None and s + chunk >= speech_end:
                            turn["t_req"] = time.monotonic()
                        nxt += step
                        await asyncio.sleep(max(0.0, nxt - time.monotonic()))
                    turn["input_audio_s"] = spec.tone_s
                else:
                    await ws.send(json.dumps({"type": "conversation.item.create", "item": {
                        "type": "message", "role": "user",
                        "content": [{"type": "input_text", "text": spec.text}]}}))
                    await ws.send(json.dumps({"type": "response.create", "response": {}}))
                    turn["t_req"] = time.monotonic()
                if turn["t_req"] is None:
                    break
                record["turns"].append(turn)
                deadline = turn["t_req"] + limit
                if voice:
                    await paced(ws, lambda: done.is_set() or time.monotonic() >= deadline)
                else:
                    try:
                        await asyncio.wait_for(done.wait(), max(0.0, deadline - time.monotonic()))
                    except asyncio.TimeoutError:
                        pass
                current.pop("turn", None)
                if turn["warmup"] and k == warmup - 1:
                    warm()
                k += 1
                if shared.closed() and k >= warmup:
                    break
                think_until = time.monotonic() + mix["think_s"]
                if voice:
                    await paced(ws, lambda: time.monotonic() >= think_until)
                else:
                    await asyncio.sleep(mix["think_s"])
            pump_task.cancel()
    except Exception as exc:  # noqa: BLE001 - a session's failure is recorded and counted, the others go on
        record["error"] = repr(exc)[:300]
    finally:
        warm()


async def run_all(url: str, plan: Plan, seconds: float) -> dict:
    shared = Shared(plan.sessions, seconds)
    out: list = []
    await asyncio.gather(*(run_session(i, plan, url, shared, out) for i in range(plan.sessions)))
    return {"t0": shared.t0, "t1": shared.t1, "sessions": sorted(out, key=lambda r: r["session"])}


def main() -> None:
    job = json.loads(sys.stdin.readline())
    plan = Plan(job["mix"], job["seed"])
    result = asyncio.run(run_all(job["url"], plan, job["seconds"]))
    result["jax_modules"] = nojax.loaded()
    print(json.dumps({"result": result}), flush=True)


if __name__ == "__main__":
    main()
