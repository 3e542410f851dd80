"""Whether what the window served is correct.

Every request of the window must come back as its prompt followed by
``new_tokens`` tokens; one that does not is ``failed``. A sample of
``check_requests`` requests (the cell's ``bench/limits/<cell>.json``),
drawn from the seed and holding the longest prompt, is then
recomputed by the plain float32 reference (``bench/reference``), each on
its wave's padded row with its served tokens fed back. For each served
token the reference's best logit at that position less its logit of the
served token is the token's gap (0 where the reference agrees). The
sampling is greedy, so a served token is the program's argmax there.

Three numbers are read (``summarize``): the widest gap of the sample,
``worst_logit_gap``; the mean gap over its served tokens,
``mean_logit_gap``; and ``decided_mean_gap``, the mean over the served
positions whose experts the reference chooses with a margin: in every
expert layer its last chosen expert's router probability leads the first
one left out by at least the cell's ``router_margin`` (without experts,
every position). Those that the cell's ``bench/limits/<cell>.json``
names are compared with their limits there; PERF.md gives the readings
each limit was set from.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from bench.reference.decoder import Decoder


@dataclass
class Verdict:
    correct: bool
    attempted: int
    failed: int
    compared: dict              # the numbers the cell's limits name
    readings: dict              # every number read, compared or not


def requests(waves):
    """(prompt, output, padded length) of every request of ``waves``."""
    return [(p, o, w.padded) for w in waves
            for p, o in zip(w.prompts, w.outputs)]


def served_ok(prompt, out, new: int) -> bool:
    return (out is not None and len(out) == len(prompt) + new
            and list(out[:len(prompt)]) == list(prompt))


def sample(reqs, k: int, seed: int) -> List[int]:
    """``k`` request indices from ``seed``: the longest prompt (the first
    such) and ``k - 1`` others."""
    longest = max(range(len(reqs)), key=lambda i: len(reqs[i][0]))
    rest = [i for i in range(len(reqs)) if i != longest]
    rng = np.random.default_rng([int(seed), 1])
    pick = rng.choice(len(rest), min(k - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[i] for i in pick)


def reference_setup() -> None:
    """Full float32 products on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def gaps(ref: Decoder, prompt, served, padded: int,
         control: Decoder = None):
    """(gaps, margins): the reference's best logit less its logit of each
    served token, or, given ``control``, of the token the control ranks
    first there; and the reference's least router margin at each of those
    positions (None without experts)."""
    logits = ref.served_logits(prompt, served, padded)
    margin = ref.router_margin
    if margin is not None:
        margin = margin[padded - 1:]
    if control is None:
        pick = torch.tensor(list(served), device=logits.device)
    else:
        pick = control.served_logits(prompt, served, padded).argmax(-1)
    return logits.max(-1).values - logits.gather(1, pick[:, None])[:, 0], \
        margin


def summarize(per_request, router_margin: float = 0.0) -> dict:
    """The numbers read (module doc) from each sampled request's
    ``gaps``."""
    if not per_request:
        per_request = [(torch.zeros(1), None)]
    g = torch.cat([r[0] for r in per_request])
    if per_request[0][1] is None:
        decided = g
    else:
        decided = g[torch.cat([r[1] for r in per_request]) >= router_margin]
    return {"worst_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "decided_mean_gap": float(decided.mean()) if decided.numel()
            else 0.0}


def judge(arch: dict, mix: dict, waves, weights: dict, seed: int,
          limits: dict) -> Verdict:
    """Hold the window's requests to ``limits``: each number it names
    (``summarize``) within its limit, and no request failed."""
    new = mix["new_tokens"]
    reqs = requests(waves)
    bad = [i for i, (p, o, _) in enumerate(reqs) if not served_ok(p, o, new)]
    reference_setup()
    ref = Decoder(weights, arch)
    per = [gaps(ref, p, o[len(p):], padded) for i, (p, o, padded) in
           ((i, reqs[i]) for i in sample(reqs, limits["check_requests"],
                                         seed))
           if i not in bad]
    readings = summarize(per, limits.get("router_margin", 0.0))
    compared = {k: {"value": readings[k], "limit": v}
                for k, v in limits.items() if k in readings}
    compared["bad_outputs"] = {"value": len(bad), "limit": 0}
    ok = not bad and all(c["value"] <= c["limit"] for c in compared.values())
    return Verdict(ok, len(reqs), len(bad), compared, readings)
