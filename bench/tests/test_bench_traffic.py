"""The traffic generator: reproducible by seed, the same lengths and
waves for every seed, in another order."""
import itertools
import json

from bench import traffic
from bench.tests.smoke import BENCH

MIXES = {m: json.loads((BENCH / "mixes" / f"{m}.json").read_text())
         for m in ("code", "conv")}


def _take(mix, seed, n):
    return list(itertools.islice(traffic.Traffic(mix, seed, 49152), n))


def test_same_seed_same_waves():
    for mix in MIXES.values():
        assert _take(mix, 2**31 + 5, 12) == _take(mix, 2**31 + 5, 12)


def test_other_seed_other_tokens_same_cycle():
    for mix in MIXES.values():
        n = mix["requests_per_cycle"] // mix["slots"]
        a, b = _take(mix, 1, n), _take(mix, 2**33 + 1, n)
        assert a != b
        lens = [sorted(map(len, w)) for w in a]
        assert sorted(lens) == sorted(sorted(map(len, w)) for w in b)
        assert sorted(lens) == sorted(sorted(w) for w in
                                      traffic.cycle_waves(mix))


def test_lengths_are_the_clipped_lognormal_quantiles():
    mix = MIXES["code"]
    lens = traffic.cycle_lengths(mix)
    assert len(lens) == mix["requests_per_cycle"]
    assert min(lens) >= mix["prompt"]["min"]
    assert max(lens) == mix["prompt"]["max"]
    assert sorted(lens)[len(lens) // 2] in range(1450, 1600)
    assert traffic.longest_wave(MIXES["conv"]) == 2048


def test_order_alternates_longer_and_shorter_waves():
    mix = MIXES["code"]
    cut = sorted(max(w) for w in traffic.cycle_waves(mix))[3]
    for seed in (0, 7, 2**31 + 3):
        waves = _take(mix, seed, 8)
        longs = [max(map(len, w)) > cut for w in waves]
        assert all(longs[i] != longs[i + 1] for i in range(0, 8, 2))


def test_token_ids_within_the_vocabulary():
    for w in _take(MIXES["conv"], 9, 4):
        assert all(0 <= t < 49152 for p in w for t in p)
