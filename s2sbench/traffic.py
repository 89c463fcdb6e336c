"""The one traffic generator: a mix file of parameters -> every session's turns.

A mix (``s2sbench/traffic/<mix>.json``) is data only.  Keys:

- ``kind``: ``voice`` (PCM16 utterances streamed at real time, endpointed
  by the server's VAD) or ``text`` (``conversation.item.create`` plus
  ``response.create``);
- ``sessions``, ``warmup_turns`` (each session's first turns, outside the
  window), ``think_s`` (closed loop: the wait after a reply's
  ``response.done``), ``start_spread_s`` (the sessions' first turns start
  over this many seconds), ``turn_limit_s``, ``instructions``;
- ``reply_tokens`` [lo, hi]: the turn's ``max_output_tokens``;
- voice: ``sample_rate``, ``chunk_ms``, ``lead_silence_s``, ``tone_s`` [lo,
  hi], ``tail_silence_s``, ``amplitude``;
- text: ``words`` [lo, hi] and ``word_list``;
- ``pool``: how many sizes each ranged parameter takes.

Every seed gets the same sizes in another order: a ranged parameter's
``pool`` values are evenly spaced over its range, and each session walks
them in an order drawn from the seed.  The seed also orders the sessions'
start offsets and picks a text turn's words; a voice turn's tone
frequency is the soak's, fixed by (session, turn), so a leak across
sessions shows.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str, root: Path = HERE) -> dict:
    """The mix ``<root>/traffic/<name>.json``."""
    return json.loads((root / "traffic" / f"{name}.json").read_text())


@dataclass(frozen=True)
class Turn:
    session: int
    index: int
    kind: str
    reply_tokens: int
    tone_s: float = 0.0
    freq_hz: float = 0.0
    text: str = ""


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), *stream]))


def _pool(lo: float, hi: float, n: int, integer: bool) -> np.ndarray:
    values = np.linspace(lo, hi, n)
    return np.round(values).astype(int) if integer else values


class Plan:
    """The turns of every session of one run, from the mix and the seed."""

    def __init__(self, mix: dict, seed: int) -> None:
        self.mix, self.seed = mix, int(seed)
        n, pool = mix["sessions"], mix["pool"]
        offsets = np.linspace(0.0, mix["start_spread_s"], n)
        self.start_offsets = [float(x) for x in offsets[_rng(seed, 0).permutation(n)]]
        self._orders = [_rng(seed, 1, s).permutation(pool) for s in range(n)]
        self._tokens = _pool(*mix["reply_tokens"], pool, True)
        if mix["kind"] == "voice":
            self._tones = _pool(*mix["tone_s"], pool, False)
        elif mix["kind"] == "text":
            self._words = _pool(*mix["words"], pool, True)
        else:
            raise ValueError(f"unknown traffic kind {mix['kind']!r}")

    @property
    def sessions(self) -> int:
        return self.mix["sessions"]

    def turn(self, session: int, index: int) -> Turn:
        pick = int(self._orders[session][index % self.mix["pool"]])
        kind = self.mix["kind"]
        if kind == "voice":
            return Turn(session, index, kind, int(self._tokens[pick]), tone_s=float(self._tones[pick]),
                        freq_hz=180.0 + 37.0 * session + 13.0 * index)
        rng = _rng(self.seed, 2, session, index)
        words = self.mix["word_list"]
        text = " ".join(words[i] for i in rng.integers(0, len(words), int(self._words[pick])))
        return Turn(session, index, kind, int(self._tokens[pick]), text=text.capitalize() + "?")

    def utterance(self, turn: Turn) -> tuple[np.ndarray, int]:
        """A voice turn's PCM16 and the sample index where its speech ends:
        lead silence, a tone with 20 ms fades, tail silence."""
        mix = self.mix
        rate = mix["sample_rate"]
        t = np.arange(int(turn.tone_s * rate)) / rate
        tone = mix["amplitude"] * np.sin(2 * np.pi * turn.freq_hz * t)
        tone *= np.minimum(1.0, np.minimum(t, t[::-1]) / 0.02)
        lead = np.zeros(int(mix["lead_silence_s"] * rate))
        tail = np.zeros(int(mix["tail_silence_s"] * rate))
        pcm = np.concatenate([lead, tone, tail])
        return (pcm * 32767).astype(np.int16), len(lead) + len(tone)
