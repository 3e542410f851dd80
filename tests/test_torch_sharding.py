"""The port's sharding rules against the JAX package's, on the CPU.

``ShardingRules`` reads only the mesh's axis names and sizes, so the
port's rules are built over a stand-in of any size; the reference's
methods are bound to a stand-in of the same sizes (as
``tests/test_sharding_data.py`` does), ``named`` returning the spec, so
no devices are forced. Specs compare as tuples: ``param_spec`` for every
leaf of ``param_axes`` of all ten architectures at full width, and the
port's per-layer ``param_shardings``; ``activation_spec`` for all nine
kinds over a grid of shapes; ``input_shardings`` (M-RoPE positions
included) and ``cache_shardings``; DTensor placements; ``plan_all``."""
import dataclasses
import itertools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.core import meshplanner as jmp
from repro.models import model as JM
from repro.models.schema import param_axes as jax_param_axes
from repro.models.schema import schema as jax_schema
from repro.roofline import analysis as janalysis
from repro.sharding import rules as jrules
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import meshplanner as mp
from repro_torch.models.model import init_cache
from repro_torch.models.schema import named_specs, param_axes, schema
from repro_torch.sharding import rules as R

MESHES = {"1x1": {"data": 1, "model": 1}, "2x1": {"data": 2, "model": 1},
          "1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
KINDS = ("acts", "acts_ffn", "logits", "heads", "expert_buf", "expert_buf4",
         "kv_cache", "tokens", "launch")


def stand_in(sizes):
    return SimpleNamespace(mesh_dim_names=tuple(sizes),
                           shape=tuple(sizes.values()))


class RefRules:
    """The reference's rule methods on a stand-in of the given sizes."""

    def __init__(self, sizes, fsdp=True):
        self._sizes = dict(sizes)
        self.dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
        self.tp_axis = "model"
        self.fsdp = fsdp
        self.seq_shard = True
        self.seq_attn_min_s = 16384
        self.param_rules = dict(jrules.DEFAULT_PARAM_RULES)
        for name in ("axes_size", "_fits", "param_spec", "activation_spec"):
            setattr(self, name,
                    getattr(jrules.ShardingRules, name).__get__(self))
        self.named = lambda spec: spec


def both(mesh, **kw):
    sizes = MESHES[mesh]
    return RefRules(sizes, **kw), R.make_rules(stand_in(sizes), **kw)


def _specs(tree):
    return [s for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, (P, R.NamedSharding)))]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_equals_the_reference(arch, mesh, fsdp):
    ref, port = both(mesh, fsdp=fsdp)
    cfg = get_config(arch)
    assert param_axes(cfg) == jax_param_axes(jax_config(arch))
    ours = list(_leaves(schema(cfg)))
    theirs = list(_leaves(jax_schema(jax_config(arch))))
    assert [(s.shape, s.axes) for s in ours] == \
        [(s.shape, s.axes) for s in theirs]
    for s in ours:
        assert port.param_spec(s.shape, s.axes) == \
            tuple(ref.param_spec(s.shape, s.axes)), (s.shape, s.axes)
    # the port's parameters: a layer's leaf without the stacked None
    stacked = {tuple(s.shape[1:]) + tuple(s.axes[1:]):
               tuple(ref.param_spec(s.shape, s.axes))[1:] for s in theirs}
    specs = named_specs(cfg)
    for name, sh in R.param_shardings(port, cfg).items():
        spec = specs[name]
        if name.startswith("layers."):
            assert sh.spec == stacked[spec.shape + spec.axes], name
        else:
            assert sh.spec == tuple(ref.param_spec(spec.shape, spec.axes))


def test_opt_state_shardings():
    _, port = both("2x2")
    cfg = get_smoke("mixtral-8x7b")
    ps = R.param_shardings(port, cfg)
    opt = R.opt_state_shardings(port, cfg)
    assert opt.m == ps and opt.v == ps and opt.step.spec == ()


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    port = R.make_rules(stand_in(MESHES["2x16x16"]))
    assert port.placements((("pod", "data"), "model", None)) == (
        Shard(0), Shard(0), Shard(1))
    assert port.placements((None, None)) == (Replicate(),) * 3
    assert port.named(("data",)).placements == (Replicate(), Shard(0),
                                                Replicate())
    with pytest.raises(ValueError, match="axis order"):
        port.placements((("data", "pod"),))


def test_rules_read_the_mesh_names_and_sizes():
    port = R.make_rules(stand_in(MESHES["16x16"]))
    assert port.dp_axes == ("data",) and port.axes_size(("data", "model")) \
        == 256 and port._sizes == {"data": 16, "model": 16}
    assert R.make_rules(stand_in(MESHES["2x16x16"])).dp_axes == ("pod",
                                                                 "data")


# ---------------------------------------------------------------------------
# activations, inputs, caches
# ---------------------------------------------------------------------------

DIMS = (1, 2, 3, 4, 8, 15, 16, 40, 256, 4095, 4096, 16384, 32768)


def _shapes(kind):
    if kind in ("acts", "acts_ffn", "expert_buf"):
        return itertools.product(DIMS, DIMS, (1024, 60, 16))
    if kind == "logits":
        return list(itertools.product(DIMS, DIMS, (256, 49155))) + \
            list(itertools.product(DIMS, (256, 49155)))
    if kind in ("heads", "kv_cache", "expert_buf4"):
        return itertools.product(DIMS, DIMS, (1, 8, 15, 16, 40), (128,))
    if kind == "tokens":
        return itertools.product(DIMS, DIMS)
    return list(itertools.product(DIMS, (4,), (8,))) + [(n,) for n in DIMS]


@pytest.mark.parametrize("kind", KINDS)
def test_activation_spec_equals_the_reference(kind):
    for mesh in MESHES:
        ref, port = both(mesh)
        for shape in _shapes(kind):
            want = ref.activation_spec(kind, shape)
            assert port.activation_spec(kind, shape) == \
                (None if want is None else tuple(want)), (mesh, shape)
    assert both("16x16")[1].activation_spec("nothing", (4, 4)) is None


def test_activation_spec_fallbacks():
    """The reference test's fallbacks, on the port's rules."""
    _, rules = both("16x16")
    assert rules.activation_spec("acts", (1, 4096, 1024))[0] is None
    assert rules.activation_spec("acts", (256, 4095, 1024))[1] is None
    s = rules.activation_spec("kv_cache", (128, 32768, 8, 128))
    assert s[1] == "model" and s[2] is None
    assert rules.activation_spec("kv_cache", (128, 32768, 16, 128))[2] \
        == "model"


@pytest.mark.parametrize("mesh", list(MESHES))
def test_input_shardings_equal_the_reference(mesh):
    """M-RoPE's (3, B, S) positions take the leading-dim rule: split over
    a dp extent of 3 (the stream axis), replicated at 2 or 4."""
    ref, port = both(mesh)
    for b in (1, 2, 3, 4, 6, 8, 16, 32, 256):
        batch = {"tokens": np.zeros((b, 8), np.int32),
                 "labels": np.zeros((b, 8), np.int32),
                 "embeds": np.zeros((b, 8, 4), np.float32),
                 "positions": np.zeros((3, b, 8), np.int64)}
        want = jrules.input_shardings(ref, batch)
        got = R.input_shardings(port, batch)
        assert set(got) == set(want)
        for k in batch:
            assert got[k].spec == tuple(want[k]), (mesh, b, k)
    three = R.make_rules(stand_in({"data": 3, "model": 1}))
    pos = R.input_shardings(three, {"positions": np.zeros((3, 6, 8))})
    assert pos["positions"].spec == ("data", None, None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_equal_the_reference(arch):
    """Each leaf of the reference's stacked caches: the port's rule at
    the per-layer shape is the reference's spec without its leading
    None; and the port's own caches map leaf for leaf."""
    jcfg = jax_smoke(arch)
    cache = jax.eval_shape(lambda: JM.init_cache(jcfg, 4, 32))
    arrays = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), cache)
    for mesh in MESHES:
        ref, port = both(mesh)
        want = _specs(jrules.cache_shardings(ref, arrays))
        leaves = jax.tree.leaves(arrays)
        assert len(want) == len(leaves)
        for leaf, spec in zip(leaves, want):
            one = R.cache_shardings(port, np.zeros(leaf.shape[1:]))
            full = tuple(spec)[1:] + (None,) * (leaf.ndim - len(spec))
            assert spec[0] is None and one.spec == full, (mesh, leaf.shape)
    _, port = both("2x2")
    ours = init_cache(get_smoke(arch), 4, 32, "cpu")
    placed = R.cache_shardings(port, ours)
    assert type(placed) is type(ours) and len(placed) == len(ours)
    pairs = list(zip(_tensors(ours), _tensors(placed)))
    assert pairs and all(len(sh.spec) == t.ndim for t, sh in pairs)


def _tensors(tree):
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          R.NamedSharding):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# MeshPlanner's plan_all
# ---------------------------------------------------------------------------

def _plain(plan):
    d = dataclasses.asdict(plan)
    for entry in d["map_log"]:
        entry["action"] = entry["action"].replace(
            "enable the flash_attention kernel (scores stay on chip)",
            "enable Pallas flash attention (scores stay in VMEM)")
    return d


@pytest.mark.parametrize("n_devices,tp", [(1, 1), (4, 2), (256, 16)])
def test_plan_all_equals_the_reference(n_devices, tp, monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(mp, name, getattr(janalysis, name))
    kw = dict(n_devices=n_devices, tp=tp, hbm_budget=janalysis.HBM_PER_CHIP)
    got = mp.plan_all(ARCH_IDS, **kw)
    want = jmp.plan_all(ARCH_IDS, **kw)
    assert list(got) == list(want)
    for key in want:
        assert _plain(got[key]) == dataclasses.asdict(want[key]), key
    two = mp.plan_all(["smollm-360m"], ["train_4k"], **kw)
    assert list(two) == ["smollm-360m/train_4k"]
