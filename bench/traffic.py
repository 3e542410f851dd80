"""The one traffic generator: waves of prompts from a mix file
(``bench/mixes/<mix>.json``) and a seed.

A mix file holds::

    {"prompt": {"median": 1500, "sigma": 0.6, "min": 128, "max": 4000},
     "new_tokens": 16, "slots": 8, "requests_per_cycle": 64, ...}

Prompt lengths are lognormal (``median``, ``sigma``) clipped to
[``min``, ``max``]. A cycle of ``requests_per_cycle`` requests takes the
distribution's quantiles at (i + 1/2) / n, so every seed serves the same
lengths. They are grouped into waves of ``slots`` by one fixed permutation
(``DESIGN_SEED``), so every seed serves the same waves too. The run's
seed orders each cycle's waves (longer and shorter half in turn, each
shuffled, so that any stretch of the run holds both), orders the rows of
each wave, and draws the token ids, uniform over the vocabulary. Every
request asks for ``new_tokens`` tokens. ``round_waves`` (default 1),
read by the harness, ends a window only after a whole round of waves:
2 for a pair of a longer and a shorter one.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Iterator, List

import numpy as np

DESIGN_SEED = 0         # the permutation that groups a cycle into waves


def cycle_lengths(mix: dict) -> List[int]:
    p = mix["prompt"]
    n = mix["requests_per_cycle"]
    nd = NormalDist()
    return [int(min(max(round(p["median"] * math.exp(
        p["sigma"] * nd.inv_cdf((i + 0.5) / n))), p["min"]), p["max"]))
        for i in range(n)]


def cycle_waves(mix: dict) -> List[List[int]]:
    """The prompt lengths of each wave of a cycle, in the design order."""
    lengths = np.array(cycle_lengths(mix))
    order = np.random.default_rng(DESIGN_SEED).permutation(
        len(lengths))
    slots = mix["slots"]
    return [lengths[order[i:i + slots]].tolist()
            for i in range(0, len(lengths), slots)]


def longest_wave(mix: dict) -> int:
    """The longest padded length of any wave (what set-up warms)."""
    return max(max(w) for w in cycle_waves(mix))


class Traffic:
    """The run's waves, endless, from ``seed`` (module doc)."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.vocab = mix, vocab
        self.rng = np.random.default_rng(int(seed))
        self.waves = cycle_waves(mix)

    def _order(self) -> List[List[int]]:
        by_len = sorted(self.waves, key=max)
        half = len(by_len) // 2
        short, long_ = by_len[:half], by_len[half:]
        self.rng.shuffle(short)
        self.rng.shuffle(long_)
        first, second = (long_, short) if self.rng.integers(2) else \
            (short, long_)
        out = []
        for i in range(max(len(first), len(second))):
            out += [w[i] for w in (first, second) if i < len(w)]
        return out

    def prompts(self, lengths) -> List[List[int]]:
        return [self.rng.integers(0, self.vocab, n).tolist()
                for n in self.rng.permutation(lengths)]

    def __iter__(self) -> Iterator[List[List[int]]]:
        while True:
            for lengths in self._order():
                yield self.prompts(lengths)
