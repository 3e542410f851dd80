"""Tensor and sequence parallelism in the sharded train step, on 2 and 4
gloo ranks on the CPU (``tests/_sharded_ranks.py``, SMOKE configs, batch
4 x 32 tokens), beside ``tests/test_torch_sharded_train.py``, which holds
the nine architectures' steps at (1, 2), (1, 4) and (2, 2) against the
one-device step.

* Each rank's dot FLOPs, counted by ``StepCost`` over one step (forward,
  backward and the recomputes of remat full), against the same step at
  (1, 1) (the one-device step, which a mesh of one rank computes): at
  (1, 4) at most 0.30 of it for Qwen1.5-0.5B, Granite-8B, Mixtral-8x7B
  and Qwen2-VL-72B, whose heads divide the axis, and below it for
  SmolLM-360M, whose 3 heads do not (its attention runs whole on every
  rank).
* Layouts the nine architectures' cases do not take, each against the
  one-device step in float64 at the bounds of
  ``test_torch_sharded_train.py``: Mixtral-8x7B with 2 experts on (1, 4),
  where the experts do not divide the axis and each expert's "ffn" dim
  is split instead (as Mixtral's 8 experts at 16); the stream whole on
  every rank (``seq_shard`` off); and sequence-parallel attention, the
  "heads" spec's split of the queries where the heads do not divide the
  axis and S reaches ``seq_attn_min_s`` (SmolLM-360M's full attention on
  (1, 2), RecurrentGemma-2B's local attention on (1, 4)); remat "dots"
  (its selective recompute reissues the collectives) and "none" (each
  unit's gathered weights kept for the backward).
* The rules' layout each case relies on, read from the rules, and every
  rank's shard of every parameter the block of the whole at its spec's
  offset (``ShardingRules.local_offset`` and ``local_shape``).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import _sharded_ranks as ranks
from repro_torch.sharding.rules import make_rules
from test_torch_sharded_train import BOUNDS, LR, TOL, _close_scaled
from test_torch_sharding import stand_in

ROOT = Path(__file__).resolve().parents[1]
DIVIDE = ("qwen1.5-0.5b", "granite-8b", "mixtral-8x7b", "qwen2-vl-72b")
COUNTED = DIVIDE + ("smollm-360m",)
FLOPS_SHARE = 0.30

LAYOUTS = [
    ("1x4/experts2/mixtral-8x7b", dict(arch="mixtral-8x7b", mesh=(1, 4),
                                       overrides={"n_experts": 2}, f64=True)),
    ("1x4/noseq/smollm-360m", dict(arch="smollm-360m", mesh=(1, 4),
                                   rules_kw={"seq_shard": False}, f64=True)),
    ("1x4/noseq/mixtral-8x7b", dict(arch="mixtral-8x7b", mesh=(1, 4),
                                    rules_kw={"seq_shard": False}, f64=True)),
    ("1x2/seqattn/smollm-360m", dict(arch="smollm-360m", mesh=(1, 2),
                                     rules_kw={"seq_attn_min_s": 32},
                                     f64=True)),
    ("1x4/seqattn/recurrentgemma-2b", dict(
        arch="recurrentgemma-2b", mesh=(1, 4),
        rules_kw={"seq_attn_min_s": 32}, f64=True)),
    ("1x2/dots/mixtral-8x7b", dict(arch="mixtral-8x7b", mesh=(1, 2),
                                   overrides={"remat": "dots"}, f64=True)),
    ("2x2/none/smollm-360m", dict(arch="smollm-360m", mesh=(2, 2),
                                  overrides={"remat": "none"}, f64=True)),
]
COUNTS = [(f"1x4/count/{a}", dict(arch=a, mesh=(1, 4), n_steps=1,
                                  count=True)) for a in COUNTED]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One world of 4 ranks and one of 2, started together."""
    tmp = tmp_path_factory.mktemp("tp_worlds")

    def on(n):
        return [(name, "steps", kw) for name, kw in LAYOUTS + COUNTS
                if kw["mesh"][0] * kw["mesh"][1] == n]
    started = [ranks.start(4, on(4), tmp / "world4"),
               ranks.start(2, on(2), tmp / "world2")]
    res = {}
    for world in started:
        res.update(ranks.collect(world))
    return res


@pytest.mark.parametrize("arch", COUNTED)
def test_per_rank_dot_flops_fall(worlds, arch):
    res = worlds[f"1x4/count/{arch}"]
    got, whole = res["sharded"]["flops"], res["one_device"]["flops"]
    assert 0 < got < whole
    if arch in DIVIDE:
        assert got <= FLOPS_SHARE * whole, got / whole


@pytest.mark.parametrize("name", [n for n, _ in LAYOUTS + COUNTS])
def test_every_shard_is_its_specs_block(worlds, name):
    assert worlds[name]["sharded"]["blocks"]


@pytest.mark.parametrize("name", [n for n, _ in LAYOUTS])
def test_layouts_within_bounds(worlds, name):
    res = worlds[name]
    got, want = res["sharded"]["state"], res["one_device"]["state"]
    grad_tol, norm_tol = BOUNDS.get(name.split("/")[-1], (TOL, 1e-6))
    for a, b in zip(res["sharded"]["metrics"], res["one_device"]["metrics"],
                    strict=True):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=norm_tol)
        assert a["lr"] == b["lr"]
    for step, (a, b) in enumerate(zip(res["sharded"]["grads"],
                                      res["one_device"]["grads"],
                                      strict=True)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _close_scaled(x, y, grad_tol, f"step {step} grad {i}")
    for n in want["params"]:
        np.testing.assert_allclose(got["params"][n].numpy(),
                                   want["params"][n].numpy(), rtol=0,
                                   atol=1e-2 * LR, err_msg=n)
        for key in ("m", "v"):
            _close_scaled(got[key][n], want[key][n], 5e-5, f"{key} {n}")


def _spec(name, arch, mesh, **rules_kw):
    from repro_torch.sharding.rules import param_shardings
    cfg = ranks.cfg_of(arch, **({"n_experts": 2} if "experts2" in name
                                else {}))
    rules = make_rules(stand_in({"data": mesh[0], "model": mesh[1]}),
                       **rules_kw)
    return cfg, rules, param_shardings(rules, cfg)


def test_the_layouts_the_cases_take():
    """Mixtral with 2 experts on 4: the experts whole, "ffn" split (the
    MoE's ffn route); with 4: the experts split. SmolLM's 3 heads on 2
    and RecurrentGemma's 2 on 4 at S = 32 >= seq_attn_min_s: the "heads"
    spec splits the queries' sequence; without it, nothing."""
    def model_dims(ps, name):
        return [i for i, e in enumerate(ps[name].spec) if e == "model"]
    _, _, ps = _spec("1x4/experts2", "mixtral-8x7b", (1, 4))
    assert model_dims(ps, "layers.0.mlp.wi") == [2]
    assert model_dims(ps, "layers.0.mlp.wo") == [1]
    _, _, ps = _spec("1x4", "mixtral-8x7b", (1, 4))
    assert model_dims(ps, "layers.0.mlp.wi") == [0]
    for arch, mesh in (("smollm-360m", (1, 2)),
                       ("recurrentgemma-2b", (1, 4))):
        cfg, rules, _ = _spec("", arch, mesh, seq_attn_min_s=32)
        shape = (4, ranks.SEQ, cfg.n_heads, cfg.hd)
        assert rules.activation_spec("heads", shape)[1] == "model"
        assert rules.activation_spec("heads", shape)[2] is None
        cfg, rules, _ = _spec("", arch, mesh)
        assert rules.activation_spec("heads", shape)[1:3] == (None, None)
    cfg, rules, _ = _spec("", "smollm-360m", (1, 4), seq_shard=False)
    assert rules.activation_spec("acts", (4, ranks.SEQ, cfg.d_model))[1:] \
        == (None, None)
    assert torch.get_default_dtype() == torch.float32
