"""The port's MoE FFN and the five configs of the MoE slice against the
JAX package, on the CPU, at f32 compute.

``models.moe.apply_moe`` is held to ``repro.models.moe.apply_moe`` on the
same numpy-seeded weights and inputs (``atol`` 1e-5: f32 sums in another
order): top-2 and top-1 of 4 experts, with capacity to spare and with
``capacity_factor`` 0.1 so that tokens drop, two batch rows that route
differently, and a planted tie in the router (equal probabilities rank
lowest index first, as ``jax.lax.top_k`` ranks them). The reference's
own MoE tests (``tests/test_models.py``) are replayed on the port. The
configs equal the reference's field by field, with equal parameter
counts, and ``launch.train`` trains both MoE SMOKE configs on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as jax_arch_ids
from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.models.config import ModelConfig as JaxConfig
from repro.models.moe import apply_moe as jax_apply_moe
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.convert import load_tree, params_from_reference
from repro_torch.launch import train as launch
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.schema import init_numpy

NEW_ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e", "granite-8b",
             "qwen1.5-0.5b", "qwen1.5-4b")
MOE_ARCHS = NEW_ARCHS[:2]
ATOL = 1e-5


def moe_cfg(**kw) -> ModelConfig:
    base = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=32, vocab_size=64, n_experts=4, topk=2,
                compute_dtype="float32", use_kernels=False)
    return ModelConfig(**{**base, **kw})


def jax_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["use_pallas"] = fields.pop("use_kernels")
    return JaxConfig(**fields)


def moe_tree(cfg, seed):
    """The first layer's MoE subtree of ``init_numpy``, unstacked."""
    mlp = init_numpy(cfg, seed)["groups"]["0"]["0"]["mlp"]
    return jax.tree.map(lambda x: np.asarray(x)[0], mlp)


def port_moe(cfg, tree):
    m = moe.MoE(cfg, "cpu")
    load_tree(m, tree)
    return m


def inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def both(cfg, tree, x):
    """(port out, port aux, JAX out, JAX aux) as numpy."""
    out, aux = moe.apply_moe(port_moe(cfg, tree), torch.from_numpy(x), cfg)
    jout, jaux = jax_apply_moe(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(x), jax_cfg(cfg))
    return out.numpy(), float(aux), np.asarray(jout), float(jaux)


def routing(cfg, tree, x):
    hx = moe.apply_norm(port_moe(cfg, tree).norm, torch.from_numpy(x), cfg)
    return moe.route(hx, torch.from_numpy(tree["router"]["w"]), cfg.topk)


# ---------------------------------------------------------------------------
# apply_moe against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topk", [2, 1])
@pytest.mark.parametrize("cf,drops", [(4.0, False), (0.1, True)],
                         ids=["spare", "drops"])
def test_apply_moe_matches_the_reference(topk, cf, drops):
    cfg = moe_cfg(topk=topk, capacity_factor=cf)
    tree = moe_tree(cfg, 1)
    x = inputs((2, 24, 16), 2)
    out, aux, jout, jaux = both(cfg, tree, x)
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    _, _, experts = routing(cfg, tree, x)
    _, keep = moe._slots(experts, cfg.n_experts,
                            moe.capacity(24, cfg))
    assert bool((~keep).any()) == drops
    # the two rows route differently, each in its own capacity
    assert not torch.equal(experts[0], experts[1])


def test_default_capacity_rounds_up_to_four():
    cfg = moe_cfg(topk=2)                    # capacity_factor 1.25
    assert [moe.capacity(s, cfg) for s in (1, 3, 13, 37, 6144)] == \
        [4, 4, 8, 24, 3840]
    mixtral = get_config("mixtral-8x7b")     # top-2 of 8
    assert [moe.capacity(s, mixtral) for s in (1, 2000, 6144)] == \
        [4, 628, 1920]
    tree = moe_tree(cfg, 3)
    x = inputs((2, 37, 16), 4)
    out, aux, jout, jaux = both(cfg, tree, x)
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


@pytest.mark.parametrize("topk", [2, 1])
def test_router_tie_ranks_the_lowest_index_first(topk):
    """Experts 1-3 have zero router columns, so their logits are exactly 0
    and their probabilities tie; expert 0's column decides whether it
    leads. The port picks as ``jax.lax.top_k`` does (``torch.topk`` would
    not, on the CPU)."""
    cfg = moe_cfg(topk=topk, capacity_factor=4.0)
    tree = moe_tree(cfg, 5)
    tree["router"]["w"][:, 1:] = 0.0
    x = inputs((2, 20, 16), 6)
    _, _, experts = routing(cfg, tree, x)
    jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(
        np.asarray(moe.apply_norm(port_moe(cfg, tree).norm,
                                  torch.from_numpy(x), cfg))
        @ tree["router"]["w"]), -1), topk)[1]
    np.testing.assert_array_equal(experts.numpy(), np.asarray(jidx))
    # of the tied experts only the lowest are picked: 1..k, or 1..k-1
    # beside expert 0
    assert int(experts.max()) <= topk
    assert bool((experts == 0).any()) and bool((experts != 0).all(-1).any())
    out, aux, jout, jaux = both(cfg, tree, x)
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


def test_dropped_pairs_add_nothing():
    """A token whose only choice overflowed its expert gets an output of
    exactly 0: the sink row is discarded before the combine, which reads
    a fresh zero row for it."""
    cfg = moe_cfg(topk=1, capacity_factor=0.1)
    tree = moe_tree(cfg, 7)
    x = inputs((2, 32, 16), 8)
    _, _, experts = routing(cfg, tree, x)
    _, keep = moe._slots(experts, cfg.n_experts, moe.capacity(32, cfg))
    out, _ = moe.apply_moe(port_moe(cfg, tree), torch.from_numpy(x), cfg)
    dropped = ~keep.reshape(2, 32)
    assert dropped.sum() > 0
    assert torch.all(out[dropped] == 0)
    assert torch.all(out[~dropped].abs().sum(-1) > 0)
    again, _ = moe.apply_moe(port_moe(cfg, tree), torch.from_numpy(x), cfg)
    assert torch.equal(out, again)


def test_moe_routing_mass_conserved():
    """The reference's test on the port: with enough capacity the output
    is finite and of x's shape, and the aux loss of near-uniform routing
    is about the coefficient."""
    cfg = moe_cfg(capacity_factor=4.0)
    p = port_moe(cfg, moe_tree(cfg, 0))
    out, aux = moe.apply_moe(p, torch.from_numpy(inputs((2, 8, 16), 0)),
                             cfg)
    assert out.shape == (2, 8, 16)
    assert bool(torch.isfinite(out).all())
    assert 0.0 < float(aux) < 1.0             # coef 0.01, balance ~1


def test_moe_capacity_drops_tokens():
    """The reference's test on the port: a tiny capacity drops tokens, and
    the output's norm falls."""
    cfg = moe_cfg(topk=1, capacity_factor=8.0)
    p = port_moe(cfg, moe_tree(cfg, 0))
    x = torch.from_numpy(inputs((1, 32, 16), 0))
    full, _ = moe.apply_moe(p, x, cfg)
    tiny, _ = moe.apply_moe(p, x, cfg.replace(capacity_factor=0.1))
    assert float(tiny.norm()) < float(full.norm())


def test_top1_gate_is_exactly_one():
    """With k = 1 the renormalised gate is 1, as in the reference: the
    router learns only through the aux loss."""
    cfg = moe_cfg(topk=1)
    _, gates, _ = routing(cfg, moe_tree(cfg, 2), inputs((2, 9, 16), 3))
    assert torch.equal(gates, torch.ones_like(gates))


def test_moe_gradients_match_the_reference():
    cfg = moe_cfg(topk=2, capacity_factor=1.0)
    tree = moe_tree(cfg, 9)
    x = inputs((2, 16, 16), 10)
    m = port_moe(cfg, tree)
    m.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.apply_moe(m, xt, cfg)
    ((out ** 2).sum() + aux).backward()

    def jloss(p, xx):
        o, a = jax_apply_moe(p, xx, jax_cfg(cfg))
        return (o ** 2).sum() + a
    gp, gx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, tree),
                                             jnp.asarray(x))
    want = {"norm.scale": gp["norm"]["scale"], "router.w": gp["router"]["w"],
            "wi": gp["wi"], "wo": gp["wo"]}
    for name, p in m.named_parameters():
        w = np.asarray(want[name])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=ATOL * float(np.abs(w).max()))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=ATOL * float(np.abs(gx).max()))


# ---------------------------------------------------------------------------
# the model with MoE layers
# ---------------------------------------------------------------------------

def test_forward_returns_the_summed_aux():
    cfg = get_smoke("mixtral-8x7b").replace(compute_dtype="float32",
                                            use_kernels=False)
    model = params_from_reference(init_numpy(cfg, 0), cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    seen = []
    orig = moe.apply_moe

    def recording(p, x, c):
        out, aux = orig(p, x, c)
        seen.append(aux)
        return out, aux
    M.apply_moe = recording
    try:
        _, _, aux = M.forward(model, cfg, tokens=tokens, mode="prefill")
    finally:
        M.apply_moe = orig
    assert len(seen) == cfg.n_layers
    assert float(aux) == pytest.approx(float(sum(seen)), rel=1e-6)
    dense = get_smoke("granite-8b").replace(compute_dtype="float32")
    dmodel = params_from_reference(init_numpy(dense, 0), dense, "cpu")
    assert float(M.forward(dmodel, dense, tokens=tokens,
                           mode="prefill")[2]) == 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decay_ndims_are_the_stacked_tree_ndims(arch):
    """The MoE leaves decay as the reference's stacked leaves do: norm
    2, router 3, wi and wo 4 dims."""
    cfg = get_smoke(arch).replace(compute_dtype="float32")
    tree = init_numpy(cfg, 0)
    model = params_from_reference(tree, cfg, "cpu")
    nd = M.decay_ndims(model)
    mlp = tree["groups"]["0"]["0"]["mlp"]
    for i in range(cfg.n_layers):
        assert nd[f"layers.{i}.mlp.norm.scale"] == mlp["norm"]["scale"].ndim
        assert nd[f"layers.{i}.mlp.router.w"] == mlp["router"]["w"].ndim
        assert nd[f"layers.{i}.mlp.wi"] == mlp["wi"].ndim == 4
        assert nd[f"layers.{i}.mlp.wo"] == mlp["wo"].ndim == 4


# ---------------------------------------------------------------------------
# configs and the launcher
# ---------------------------------------------------------------------------

def test_the_port_runs_seven_architectures():
    """The port's registry holds the JAX package's ten architectures
    (seven once; the xLSTM, HuBERT and Qwen2-VL configs since)."""
    assert len(ARCH_IDS) == 10
    assert set(NEW_ARCHS) <= set(ARCH_IDS)
    assert ARCH_IDS == jax_arch_ids


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_the_reference_field_by_field(arch):
    for ours, theirs in ((get_config(arch), jax_config(arch)),
                         (get_smoke(arch), jax_smoke(arch))):
        a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        assert a.pop("use_kernels") is True
        assert b.pop("use_pallas") is False
        assert a == {k: b[k] for k in a}
        defaults = {f.name: f.default for f in dataclasses.fields(
            type(theirs))}
        assert {k: b[k] for k in b if k not in a} == \
            {k: defaults[k] for k in b if k not in a}
        assert ours.n_params() == theirs.n_params()
        assert ours.n_active_params() == theirs.n_active_params()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launch_train_an_moe_config_on_the_cpu(arch, tmp_path, capsys):
    out = launch.main(["--arch", arch, "--steps", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)])
    assert "final loss" in capsys.readouterr().out
    assert np.isfinite(out["final_loss"]) and out["steps"] == 2
    assert out["trainer"].cfg.n_experts == get_smoke(arch).n_experts
