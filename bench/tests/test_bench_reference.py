"""The benchmark's plain reference against the port, on the CPU, at both
configurations' small sizes: the engine served in float32 (its kernels'
plain versions on CPU tensors), every logit row it sampled from, against
the reference's logits of the same padded rows and served tokens. The
waves mix prompt lengths, so rows carry left pads; at a capacity factor
of 0.5 the MoE rows drop pairs past their capacity; Mixtral's window
(16) is shorter than the rows, so it masks; a granite case ties the head
to the embedding, as granite-8b does."""
import json

import numpy as np
import pytest
import torch

from bench import check, system, weights as W
from bench.reference import decoder
from bench.reference.decoder import Decoder
from bench.tests.smoke import DATA, REPO

system.load(REPO)


def _arch(name, **kw):
    arch = json.loads((DATA / f"{name}.json").read_text())
    return {**arch, **kw}


def _served_with_logits(arch, seed, prompts, new):
    weights = W.make(arch, seed, "cpu")
    engine, _ = system.build(arch, weights, len(prompts), seed)
    rows = []
    sample = engine._sample

    def recording(logits, gen):
        rows.append(logits.float().clone())
        return sample(logits, gen)
    engine._sample = recording
    out = engine.generate(prompts, new)
    return weights, out, torch.stack(rows, 1)        # (B, new, V)


CASES = [("granite-smoke", {}),
         ("granite-smoke", {"tie_word_embeddings": True}),
         ("mixtral-smoke", {}), ("mixtral-smoke", {"capacity_factor": 0.5})]


@pytest.mark.parametrize("name,kw", CASES)
@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_reference_matches_the_port_in_f32(name, kw, seed):
    arch = _arch(name, compute_dtype="float32", **kw)
    rng = np.random.default_rng(seed)
    lengths = [40, 23, 7, 31]
    prompts = [rng.integers(0, arch["vocab_size"], n).tolist()
               for n in lengths]
    new = 6
    weights, out, logits = _served_with_logits(arch, seed, prompts, new)
    ref = Decoder(weights, arch)
    for r, p in enumerate(prompts):
        want = ref.served_logits(p, out[r][len(p):], max(lengths))
        torch.testing.assert_close(logits[r], want, atol=2e-4, rtol=2e-4)


def test_smoke_moe_rows_drop_pairs():
    """The last case above exercises capacity: a prefill row has an
    expert asked for more than its capacity."""
    arch = _arch("mixtral-smoke", capacity_factor=0.5)
    weights = W.make(arch, 3, "cpu")
    ref = Decoder(weights, arch)
    seen = []
    orig = ref._moe

    def spy(h, p, prefill_len):
        probs = torch.softmax(h @ weights[p + "router.w"], -1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :2]
        counts = torch.bincount(top[:prefill_len].reshape(-1), minlength=4)
        seen.append(int(counts.max()) - decoder.capacity(prefill_len, arch))
        return orig(h, p, prefill_len)
    ref._moe = spy
    row = torch.from_numpy(np.random.default_rng(3).integers(0, 256, 40))
    ref.logits(row, 40, 39)
    assert max(seen) > 0


def test_capacity_rule():
    arch = {"num_experts_per_tok": 2, "num_local_experts": 8,
            "capacity_factor": 1.25}
    assert decoder.capacity(1, arch) == 4          # 0.3125 -> 1 -> 4
    assert decoder.capacity(2048, arch) == 640
    assert decoder.capacity(13, arch) == 4         # 4.06 -> 4
    assert decoder.capacity(14, arch) == 4         # 4.375 -> 4
    assert decoder.capacity(20, arch) == 8         # 6.25 -> 6 -> 8


def test_fp8_control_rounds_to_three_mantissa_bits():
    t = torch.tensor([[1.0, 1.0625, 1.125, 448.0]])
    q = decoder._fp8(t, -1)
    assert q[0, 0] == 1.0 and q[0, 2] == 1.125 and q[0, 3] == 448.0
    assert q[0, 1] in (1.0, 1.125)


def test_gaps_are_zero_where_the_reference_agrees():
    arch = _arch("granite-smoke", compute_dtype="float32")
    weights = W.make(arch, 5, "cpu")
    ref = Decoder(weights, arch)
    prompt = list(range(1, 12))
    served = []
    for _ in range(4):
        served.append(int(ref.served_logits(prompt, served + [0], 11)[-1]
                          .argmax()))
    g, margin = check.gaps(ref, prompt, served, 11)
    assert g.shape == (4,) and float(g.max()) == 0.0 and margin is None
    wrong = served[:2] + [int(ref.served_logits(prompt, served, 11)[2]
                              .argmin())] + served[3:]
    assert float(check.gaps(ref, prompt, wrong, 11)[0][2]) > 0



def test_summarize_by_hand():
    g = [(torch.tensor([0.0, 0.4, 0.0]), torch.tensor([0.2, 0.001, 0.3])),
         (torch.tensor([0.2]), torch.tensor([0.01]))]
    r = check.summarize(g, router_margin=0.005)
    assert r["worst_logit_gap"] == pytest.approx(0.4)
    assert r["mean_logit_gap"] == pytest.approx(0.15)
    assert r["decided_mean_gap"] == pytest.approx(0.2 / 3)
    dense = check.summarize([(torch.tensor([0.0, 0.3]), None)])
    assert dense["decided_mean_gap"] == dense["mean_logit_gap"]


def test_router_margins_follow_the_served_positions():
    arch = _arch("mixtral-smoke")
    weights = W.make(arch, 4, "cpu")
    ref = Decoder(weights, arch)
    g, margin = check.gaps(ref, list(range(1, 21)), [5, 6, 7], 24)
    assert g.shape == margin.shape == (3,)
    assert bool((margin >= 0).all())
