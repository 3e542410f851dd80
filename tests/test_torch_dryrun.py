"""The port's dry-run tooling on the CPU: input specs, the step-cost
counter, the kernels' meta route, ``dryrun.run_cell`` on a stand-in
world and ``MeshPlanner.validate``, held against hand counts and the JAX
package.

A world (torch's fake process group) opens once per process, so
everything that needs one runs in one subprocess
(``tests/_dryrun_world.py``, a world of 256 ranks holding the 16 x 16
mesh and the one-device mesh), started before the first test; the JAX
package runs here, in the same process as the port's tests.

* ``input_layout`` (the inputs ``input_specs`` places) for every arch x
  shape on a 16 x 16 and a 2 x 16 x 16 stand-in: every leaf's shape,
  dtype and spec equal the reference's ``input_specs``.
* ``StepCost`` against hand counts: dots, bytes, views, a convolution,
  the peak of a small module; an all-reduce and all-gathers at their
  ring bytes.
* Dot FLOPs of SMOKE cells on a one-device mesh against the reference's
  ``HloCost`` of the compiled step. Tolerance 0 once two measured terms
  are added back, each a dot XLA drops and eager PyTorch runs:
  the logits of the chunked loss, computed in the forward and again in
  its checkpoint's backward, which XLA merges into one (CSE) when the
  step has one microbatch (2 B S V d); and blocked attention's P @ V,
  which the port's per-chunk checkpoint recomputes in the backward and
  XLA drops because the gradient does not read it (2 B H S^2 hd a
  layer, at one chunk pair; windowed attention saves no such dot).
  Prefill and decode read the same.
* ``run_cell`` at 16 x 16: the reference record's keys; collectives
  equal to a count of what the port's step issues: every collective the
  sharded train or serving step issues, recorded where it issues them
  (``sharding.ctx``'s gather, reduce-scatter, all-reduce and all-to-all;
  ``tests/_dryrun_world.py``), which the counter sees at the
  dispatcher. A serving cell's arguments are rank 0's blocks: each
  parameter's shard, the batch's rows and each cache leaf's block by
  ``cache_shardings``, not whole parameters.
* The kernels' meta route and their noted work; ``validate``'s knobs.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.launch import specs as jspecs
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models.config import ShapeSpec as JShapeSpec
from repro.models.steps import make_decode_step as jdecode
from repro.models.steps import make_prefill_step as jprefill
from repro.models.steps import make_train_step as jtrain
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.roofline import analysis as janalysis
from repro.roofline.hlo_parse import HloCost
from repro.sharding import set_rules as jset_rules
from repro.sharding.rules import make_rules as jmake_rules
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import meshplanner as mp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.launch import dryrun, specs
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.models.schema import layer_groups, leaves, named_specs
from repro_torch.roofline import analysis as RL
from repro_torch.roofline.counter import StepCost
from repro_torch.sharding import rules as R
import _dryrun_world as W
from test_torch_sharding import MESHES, RefRules, stand_in

ROOT = Path(__file__).resolve().parents[1]
HELPER = ROOT / "tests" / "_dryrun_world.py"


class _World:
    """The helper's subprocess: started once, read once."""

    def __init__(self):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        self.proc = subprocess.Popen(
            [sys.executable, str(HELPER)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))
        self._out = None

    def result(self) -> dict:
        if self._out is None:
            out, err = self.proc.communicate(timeout=300)
            assert self.proc.returncode == 0, err[-4000:]
            self._out = json.loads(out.strip().splitlines()[-1])
        return self._out


@pytest.fixture(scope="module", autouse=True)
def world():
    w = _World()
    yield w
    if w.proc.poll() is None:
        w.proc.kill()
        w.proc.communicate()


# ---------------------------------------------------------------------------
# (a) input specs
# ---------------------------------------------------------------------------

class _Sds:
    """The reference's ``ShapeDtypeStruct`` with a bare spec for its
    sharding (a stand-in mesh has no devices)."""

    def __init__(self, shape, dtype, sharding=None):
        self.shape, self.dtype, self.sharding = tuple(shape), dtype, sharding

    @property
    def ndim(self):
        return len(self.shape)


def _jdt(x) -> str:
    return str(np.dtype(x.dtype))


def _tdt(t) -> str:
    return str(t.dtype).rsplit(".", 1)[-1]


def _spec(p) -> tuple:
    return () if p is None else tuple(p)


def _unstacked(ref_tree, cfg):
    """{port name: (shape, dtype, spec)} of a reference tree laid out as
    the parameters (a layer's leaf without its repeats dim and spec's
    leading None)."""
    out = {}
    for path, leaf in leaves({k: v for k, v in ref_tree.items()
                              if k != "groups"}):
        out[path.replace("/", ".")] = (leaf.shape, _jdt(leaf),
                                       _spec(leaf.sharding))
    layer = 0
    for gi, (unit, reps) in enumerate(layer_groups(cfg)):
        group = ref_tree["groups"][str(gi)]
        for rep in range(reps):
            for idx in range(len(unit)):
                for path, leaf in leaves(group[str(idx)]):
                    spec = _spec(leaf.sharding)
                    assert spec[0] is None
                    name = f"layers.{layer + rep * len(unit) + idx}." \
                        + path.replace("/", ".")
                    out[name] = (leaf.shape[1:], _jdt(leaf), spec[1:])
        layer += reps * len(unit)
    return out


def _port(tree, shardings):
    """{name: (shape, dtype, spec)} of a port tree of tensors."""
    return {n: (tuple(t.shape), _tdt(t), shardings[n].spec)
            for n, t in tree.items()}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch, shape, mesh, monkeypatch):
    monkeypatch.setattr(jspecs, "_sds", _Sds)
    sizes = MESHES[mesh]
    ref = jspecs.input_specs(jax_config(arch), JShapeSpec(
        *dataclasses.astuple(SHAPES[shape])), RefRules(sizes))
    cfg = get_config(arch)
    got = specs.input_layout(cfg, SHAPES[shape], R.make_rules(
        stand_in(sizes)))
    assert len(got) == len(ref)
    assert _port(*got[0]) == _unstacked(ref[0], cfg)
    kind = SHAPES[shape].kind
    if kind in ("train", "prefill"):
        (batch, bsh), jbatch = got[-1], ref[-1]
        assert set(batch) == set(jbatch)
        for k, t in batch.items():
            assert (tuple(t.shape), _tdt(t), bsh[k].spec) == \
                (jbatch[k].shape, _jdt(jbatch[k]),
                 _spec(jbatch[k].sharding)), k
    if kind == "train":
        (opt, osh), jopt = got[1], ref[1]
        for moment in ("m", "v"):
            assert _port(getattr(opt, moment), getattr(osh, moment)) == \
                _unstacked(getattr(jopt, moment), cfg)
        assert (tuple(opt.step.shape), _tdt(opt.step), osh.step.spec) == \
            ((), "int32", ())
        assert _jdt(jopt.step) == "int32" and _spec(jopt.step.sharding) == ()
    if kind == "decode":
        (cache, csh), jcache = got[1], ref[1]
        layer = 0
        for gi, (unit, reps) in enumerate(layer_groups(cfg)):
            for rep in range(reps):
                for idx in range(len(unit)):
                    i = layer + rep * len(unit) + idx
                    mine = [(tuple(t.shape), _tdt(t), s.spec) for t, s in zip(
                        torch.utils._pytree.tree_leaves(cache[i]),
                        _shardings(csh[i]))]
                    theirs = [(x.shape[1:], _jdt(x), _spec(x.sharding)[1:])
                              for x in jax.tree.leaves(
                                  jcache[str(gi)][str(idx)])]
                    assert mine == theirs, (i, unit[idx])
            layer += reps * len(unit)
        for (t, sh), x in zip(got[2:], ref[2:]):
            assert (tuple(t.shape), _tdt(t), sh.spec) == \
                (x.shape, _jdt(x), _spec(x.sharding))


def _shardings(tree):
    """The NamedShardings of a NamedTuple of them, nested ones in order."""
    out = []
    for x in tree:
        out.extend([x] if isinstance(x, R.NamedSharding) else _shardings(x))
    return out


# ---------------------------------------------------------------------------
# (b) the counter against hand counts
# ---------------------------------------------------------------------------

def _count(fn, *hold):
    with StepCost() as cost:
        cost.hold(*hold)
        out = fn()
    return cost, out


def test_counter_linear_bmm_einsum():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 4, 8, generator=g), torch.randn(16, 8, generator=g)
    cost, out = _count(lambda: F.linear(x, w))
    assert cost.flops == 2 * 8 * 16 * 8
    # x and w read, the output written; the reshapes and w.t() are views
    assert cost.bytes == (64 + 128 + 128) * 4
    a, b = torch.randn(3, 4, 5, generator=g), torch.randn(3, 5, 6, generator=g)
    cost, _ = _count(lambda: torch.bmm(a, b))
    assert cost.flops == 2 * 3 * 4 * 6 * 5
    assert cost.bytes == (60 + 90 + 72) * 4
    q, k = torch.randn(2, 3, 4, generator=g), torch.randn(2, 5, 4, generator=g)
    cost, _ = _count(lambda: torch.einsum("bqd,bkd->bqk", q, k))
    assert cost.flops == 2 * 2 * 3 * 5 * 4
    bias = torch.randn(16, generator=g)
    cost, _ = _count(lambda: F.linear(x, w, bias))
    assert cost.flops == 2 * 8 * 16 * 8


def test_counter_skips_convolutions_and_views():
    from torch.utils.flop_counter import FlopCounterMode
    x, w = torch.randn(1, 4, 16), torch.randn(8, 4, 3)
    cost, _ = _count(lambda: F.conv1d(x, w))
    with FlopCounterMode(display=False) as stock:
        F.conv1d(x, w)
    assert cost.flops == 0
    assert cost.raw_flops == stock.get_total_flops() == 2 * 8 * 14 * 4 * 3
    y = torch.randn(4, 6)
    cost, _ = _count(lambda: (y.view(6, 4), y.t(), y.permute(1, 0),
                              y[:, :2], y.unsqueeze(0).expand(2, 4, 6),
                              torch.as_strided(y, (2, 2), (1, 1)),
                              y.reshape(24), torch.empty(100)))
    assert cost.bytes == 0 and cost.raw_bytes > 0
    cost, _ = _count(lambda: y + y)
    assert cost.bytes == 3 * 24 * 4


def test_counter_peak_of_a_small_module():
    """Forward of Linear(64, 32) -> ReLU -> Linear(32, 8), no bias, on a
    (16, 64) f32 input: arguments 32*64 + 8*32 + 16*64 floats; the peak
    holds them, the first product and its ReLU (the product is freed
    once the ReLU's output replaces it); the output is 16*8 floats."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(64, 32, bias=False),
                              torch.nn.ReLU(),
                              torch.nn.Linear(32, 8, bias=False))
    x = torch.randn(16, 64)
    with torch.no_grad():
        cost, out = _count(lambda: net(x), net, x)
    args = (32 * 64 + 8 * 32 + 16 * 64) * 4
    assert cost.arg_bytes == args
    assert cost.peak == args + 2 * 16 * 32 * 4
    assert cost.out_bytes(out) == 16 * 8 * 4
    assert cost.live == args + 16 * 8 * 4


def test_collectives_at_ring_bytes(world):
    """On the stand-in world: 1,000 f32 all-reduced over "data" (n = 16):
    2 (n-1)/n of 4,000 bytes; a (64, 8) f32 DTensor split 16 ways over
    "model" gathered: (n-1)/n of its 2,048 bytes; a (32, 48) f32 DTensor
    split over both axes: two gathers, of 1/16 of it and of all of it."""
    c = world.result()["collectives"]
    assert c["all_reduce"]["calls"] == [["all-reduce", 16, 4000]]
    assert c["all_reduce"]["ring_bytes"] == 2 * 15 / 16 * 4000
    assert c["gather_model"]["calls"] == [["all-gather", 16, 2048]]
    assert c["gather_model"]["ring_bytes"] == 15 / 16 * 2048
    full = 32 * 48 * 4
    assert c["gather_both"]["calls"] == [["all-gather", 16, full // 16],
                                         ["all-gather", 16, full]]
    assert c["gather_both"]["ring_bytes"] == 15 / 16 * (full // 16 + full)
    assert RL.parse_collectives([("all-reduce", 1, 4000)]).ring_bytes == 0
    assert RL.ring_bytes("reduce-scatter", 16, 100) == 1500
    assert RL.ring_bytes("collective-permute", 2, 100) == 100


def test_roofline_schema_is_the_reference():
    assert [f.name for f in dataclasses.fields(RL.Roofline)] == \
        [f.name for f in dataclasses.fields(janalysis.Roofline)]
    assert [f.name for f in dataclasses.fields(RL.CollectiveStats)] == \
        [f.name for f in dataclasses.fields(janalysis.CollectiveStats)]


# ---------------------------------------------------------------------------
# (c) dot FLOPs against the reference's HloCost
# ---------------------------------------------------------------------------

def _ref_flops(arch, kind, remat, mb) -> float:
    cfg = jax_smoke(arch)
    if remat:
        cfg = cfg.replace(remat=remat)
    shape = JShapeSpec(kind, W.SEQ, W.ROWS, kind)
    step = {"train": lambda: jtrain(cfg, JAdamW(), microbatches=mb),
            "prefill": lambda: jprefill(cfg),
            "decode": lambda: jdecode(cfg)}[kind]()
    mesh = jax_host_mesh()
    rules = jmake_rules(mesh)
    with jset_rules(rules), mesh:
        args = jspecs.input_specs(cfg, shape, rules)
        compiled = jax.jit(step).lower(*args).compile()
    return HloCost(compiled.as_text()).entry_cost().flops


def _dropped_by_xla(arch, kind, mb) -> int:
    """The dots the port runs and XLA removes (module docstring)."""
    cfg = get_smoke(arch)
    if kind != "train":
        return 0
    b, s = W.ROWS, W.SEQ
    logits = 2 * b * s * cfg.vocab_size * cfg.d_model if mb == 1 else 0
    n_attn = sum(k == "attn" for k in cfg.pattern())
    pv = 0 if cfg.window else \
        n_attn * 2 * b * cfg.n_heads * s * s * cfg.hd
    return logits + pv


@pytest.mark.parametrize("cell", W.HOST_CELLS, ids=lambda c: "-".join(
    map(str, c)))
def test_dot_flops_against_hlo_cost(cell, world):
    arch, kind, remat, mb = cell
    port = next(r["flops"] for r in world.result()["host_cells"]
                if [r["arch"], r["kind"], r["remat"], r["mb"]] == list(cell))
    ref = _ref_flops(arch, kind, remat, mb)
    # tolerance 0: equal once the dots XLA drops are added back
    assert port == ref + _dropped_by_xla(arch, kind, mb)


def test_real_step_counts_as_its_dry_run(world):
    """SmolLM's SMOKE step run for real on the CPU (the one-device mesh)
    counts what its meta trace counts: FLOPs, bytes, arguments, peak."""
    r = world.result()["real_step"]
    assert r["real"] == r["dry"]


# ---------------------------------------------------------------------------
# (d) run_cell on the 16 x 16 stand-in world
# ---------------------------------------------------------------------------

REF_RECORD_EXTRA = ("lower_s", "compile_s", "n_devices", "fits_hbm",
                    "total_dev_bytes")     # src/repro/launch/dryrun.py:98


def _expected_collectives(issued):
    """What the port's step issues at 16 x 16 (2 rows a dp rank): the
    calls the sharded step issued (``issued``)."""
    return RL.parse_collectives([tuple(c) for c in issued])


def _arg_bytes(cfg, shape) -> int:
    """Rank 0's arguments of a serving cell at 16 x 16: each parameter's
    block, the batch's rows or the decode token's, and each cache leaf's
    block, laid out by the rules (``launch.specs.input_layout``)."""
    rules = R.make_rules(stand_in(MESHES["16x16"]))
    total = 0
    for tree, shardings in specs.input_layout(cfg, shape, rules):
        leaves = torch.utils._pytree.tree_leaves(tree)
        shs = torch.utils._pytree.tree_leaves(
            shardings, is_leaf=lambda x: isinstance(x, R.NamedSharding))
        for t, sh in zip(leaves, shs, strict=True):
            total += int(np.prod(rules.local_shape(t.shape, sh.spec),
                                 dtype=np.int64)) * t.element_size()
    return total


@pytest.mark.parametrize("cell", W.PROD_CELLS, ids=lambda c: "-".join(
    map(str, c)))
def test_run_cell_at_16x16(cell, world):
    res = next(r for r in world.result()["production_cells"]
               if [r["arch"], r["kind"], r["remat"]] == list(cell))
    rec = res["record"]
    ref_roof = janalysis.Roofline(
        flops=0, bytes_hbm=0, collectives=janalysis.CollectiveStats(),
        compute_s=0, memory_s=0, collective_s=0, bound="compute").asdict()
    assert set(rec) == {"arch", "shape", "mesh", "supported", "reason"} \
        | set(ref_roof) | set(REF_RECORD_EXTRA)
    assert set(rec["collectives"]) == set(ref_roof["collectives"])
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["compile_s"] == 0 and rec["supported"]
    want = _expected_collectives(res["issued"])
    assert rec["collectives"]["counts"] == dict(want.counts)
    assert rec["collectives"]["ring_bytes"] == pytest.approx(
        want.ring_bytes, rel=1e-12)
    assert rec["total_dev_bytes"] == rec["arg_bytes"] + rec["temp_bytes"] \
        + rec["out_bytes"]
    assert rec["fits_hbm"] == (rec["total_dev_bytes"] <= RL.HBM_PER_CHIP)


@pytest.mark.parametrize("cell", [c for c in W.PROD_CELLS
                                  if c[1] != "train"],
                         ids=lambda c: "-".join(map(str, c[:2])))
def test_serving_arguments_are_the_ranks_blocks(cell, world):
    """A serving cell's arguments are rank 0's blocks (module doc), far
    below the whole parameters' bytes."""
    res = next(r for r in world.result()["production_cells"]
               if [r["arch"], r["kind"], r["remat"]] == list(cell))
    arch, kind, _ = cell
    assert res["record"]["arg_bytes"] == _arg_bytes(
        get_smoke(arch), ShapeSpec(kind, W.SEQ, W.PROD_ROWS, kind))
    whole = sum(int(np.prod(s.shape)) * 4
                for s in named_specs(get_smoke(arch)).values())
    assert res["record"]["arg_bytes"] < whole


def test_prefill_32k_arguments_are_the_ranks_shards(world):
    """Qwen1.5-0.5B x prefill_32k at its published widths: rank 0's
    arguments are its parameter shards and its 2 of the 32 prompts,
    under a tenth of the whole parameters' bytes (the step no longer
    gathers them: 16 "model" ranks, FSDP over 16 "data" ranks)."""
    rec = world.result()["prefill_32k"]
    cfg = get_config("qwen1.5-0.5b")
    assert rec["arg_bytes"] == _arg_bytes(cfg, SHAPES["prefill_32k"])
    whole = sum(int(np.prod(s.shape)) * 4
                for s in named_specs(cfg).values())
    assert rec["arg_bytes"] < whole / 10


# ---------------------------------------------------------------------------
# (e) the kernels' meta route
# ---------------------------------------------------------------------------

def _mask_pairs(sq, skv, causal, window) -> int:
    """The mask ``attention_ref`` builds, counted."""
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return int(mask.sum())


@pytest.mark.parametrize("causal,window,sq,skv", [
    (True, 0, 96, 96), (True, 40, 96, 96), (False, 0, 96, 96),
    (False, 16, 64, 80), (True, 0, 64, 80)])
def test_flash_attention_meta_route(causal, window, sq, skv):
    meta = torch.device("meta")
    q = torch.empty(4, sq, 32, dtype=torch.bfloat16, device=meta)
    k = torch.empty(2, skv, 32, dtype=torch.bfloat16, device=meta)
    before = fa.LAUNCHES
    with StepCost() as cost:
        out = fa.flash_attention(q, k, k.clone(), causal=causal,
                                 window=window)
    assert (out.shape, out.dtype, out.device) == (q.shape, q.dtype, meta)
    assert fa.LAUNCHES == before
    pairs = _mask_pairs(sq, skv, causal, window)
    assert fa.visible_pairs(sq, skv, causal, window) == pairs
    assert cost.kernels["flash_attention"] == {
        "launches": 1, "flops": 4 * 32 * 4 * pairs,
        "bytes": 2 * (4 * sq + 2 * skv) * 32 * 2}
    assert cost.flops == 4 * 32 * 4 * pairs


def test_rglru_scan_meta_route_and_no_counter():
    meta = torch.device("meta")
    a = torch.empty(2, 10, 8, device=meta)
    h0 = torch.empty(2, 8, device=meta)
    before = rg.LAUNCHES
    with StepCost() as cost:
        h, hf = rg.rglru_scan(a, a.clone(), h0)
    assert (h.shape, hf.shape, h.device) == (a.shape, h0.shape, meta)
    assert rg.LAUNCHES == before
    assert cost.kernels["rglru_scan"] == {"launches": 1, "flops": 0,
                                          "bytes": (3 * 160 + 2 * 16) * 4}
    h, _ = rg.rglru_scan(a, a.clone(), h0)     # no counter: nothing noted
    assert h.device == meta and cost.kernels["rglru_scan"]["launches"] == 1


def test_prefill_on_meta_notes_every_kernel():
    """RecurrentGemma's SMOKE prefill on the meta device with the kernels
    on: one flash_attention note per attention layer, one rglru_scan
    note per recurrent layer, nothing launched."""
    cfg = get_smoke("recurrentgemma-2b").replace(use_kernels=True)
    model = M.LM(cfg, "meta")
    tokens = torch.empty(2, 48, dtype=torch.int32, device="meta")
    with torch.no_grad(), StepCost() as cost:
        logits, _ = M.prefill(model, cfg, tokens=tokens)
    assert logits.shape == (2, cfg.vocab_size)
    kinds = cfg.pattern()
    assert cost.kernels["flash_attention"]["launches"] == \
        sum(k != "rglru" for k in kinds)
    assert cost.kernels["rglru_scan"]["launches"] == kinds.count("rglru")


# ---------------------------------------------------------------------------
# (f) validate
# ---------------------------------------------------------------------------

def test_validate_passes_the_plans_knobs(monkeypatch):
    seen = {}

    def run_cell(arch, shape, **kw):
        seen.update(kw, arch=arch, shape=shape)
        return {"record": True}
    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    shape = ShapeSpec("launch", 2048, 8, "train")
    plan = mp.plan(get_config("smollm-360m"), shape)
    plan.knobs = mp.Knobs(remat="full", fsdp=False, seq_shard=False,
                          microbatches=4, use_flash_kernel=True)
    assert mp.validate(plan, shape=shape, host=True, out_dir="d") == \
        {"record": True}
    assert seen == {"arch": "smollm-360m", "shape": shape, "multi_pod": False,
                    "host": True, "remat": "full", "microbatches": 4,
                    "fsdp": False, "seq_shard": False,
                    "use_flash_kernel": True, "out_dir": "d"}
    plan = mp.plan(get_config("granite-8b"), SHAPES["train_4k"],
                   n_devices=256, tp=16)
    mp.validate(plan, multi_pod=True)
    assert seen["shape"] == "train_4k" and seen["multi_pod"] \
        and seen["remat"] == plan.knobs.remat and not seen["host"]
