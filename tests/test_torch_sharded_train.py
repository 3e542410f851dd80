"""Sharded training on 2 and 4 gloo ranks on the CPU (spawned, one
thread each), against the port's one-device step and the JAX package's
Trainer on a (2, 2) mesh of forced host devices.

Each mesh shape runs every architecture in one spawn
(``tests/_sharded_ranks.py``); rank 0 also runs the one-device steps from
the same weights and global batches, in the same process. SMOKE configs
at f32 compute, attention tiles cut to 8 x 16, 3 steps at lr 1e-3, batch
4 x 32 tokens; Qwen2-VL feeds (3, B, S) M-RoPE positions.

* Data extent 1 ((1, 2), (1, 4)): losses, grad norms, every gradient, the
  parameters, both moments and the step bit for bit: gathering, slicing
  and elementwise updates change no rounding. So does a batch the dp
  axes do not divide (3 rows on (2, 1)): every rank computes every row.
* Data-parallel ((2, 1), (2, 2)), the MoE aux over the global batch and
  2 microbatches included: the gradient sums run in another order. Loss
  and grad norm within 1e-6 relative, every gradient within 1e-5 of its
  tensor's largest, the parameters after 3 steps within 1e-2 x lr and the
  moments within 5e-5 of each tensor's largest: the bounds
  ``tests/test_torch_train.py`` holds the port to against the JAX
  package, which sums in other orders too. xLSTM-350M alone is held to
  5e-5 (gradients) and 2e-5 (grad norm), from readings: at (2, 1) its
  gradients differ from the one-device step's by 5.5e-7, 8.3e-6 and
  1.3e-5 of each tensor's largest over the 3 steps, the grad norm (29 ->
  51) by 0, 3.4e-7 and 3.9e-6; the first step's parameters are the same,
  so the growth is the later steps' inputs differing by the f32 rounding
  AdamW carries into them (the params 6e-3 x lr apart). That first-step
  difference is rounding: the one-device step's own f32 gradients are
  1.4e-5 of each tensor's largest from their f64 values, on 4 rows and on
  2 + 2 alike. The other eight read at most 3.9e-6 (gradients), 1.6e-7
  (loss and grad norm), 7.9e-3 x lr (params) and 4.2e-6 (moments).
* A checkpoint saved by the Trainer at (2, 2) restores at (1, 2), at
  (2, 1) and on one device bit for bit, each rank's blocks its parts;
  the Trainer on (1, 2) resumes from it to step 6 bit for bit as the
  one-device Trainer does (the elastic restart).
* The port's Trainer at (2, 2) and the JAX Trainer at (2, 2) (4 steps, 2
  microbatches, SmolLM-360M): losses within 1e-6 relative.
* Every shard's numel is the global size over its spec's mesh extents.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import _sharded_ranks as ranks
from repro_torch.train import checkpoint

ROOT = Path(__file__).resolve().parents[1]
NINE = ("smollm-360m", "recurrentgemma-2b", "mixtral-8x7b",
        "llama4-scout-17b-a16e", "granite-8b", "qwen1.5-0.5b", "qwen1.5-4b",
        "xlstm-350m", "qwen2-vl-72b")
THREE = ("smollm-360m", "mixtral-8x7b", "qwen2-vl-72b")
LR = ranks.LR
TOL = 1e-5
# (gradient, grad norm) bounds from readings (module doc)
BOUNDS = {"xlstm-350m": (5e-5, 2e-5)}

EXACT = ([(f"1x2/{a}", dict(arch=a, mesh=(1, 2))) for a in NINE]
         + [("1x2/mb2/mixtral-8x7b", dict(arch="mixtral-8x7b", mesh=(1, 2),
                                           microbatches=2)),
            ("2x1/rows3/smollm-360m", dict(arch="smollm-360m", mesh=(2, 1),
                                            rows=3))])
BOUNDED = ([(f"2x1/{a}", dict(arch=a, mesh=(2, 1))) for a in NINE]
           + [("2x1/mb2/mixtral-8x7b", dict(arch="mixtral-8x7b",
                                             mesh=(2, 1), microbatches=2)),
              ("2x1/mb2/qwen2-vl-72b", dict(arch="qwen2-vl-72b",
                                             mesh=(2, 1), microbatches=2))])
EXACT4 = [(f"1x4/{a}", dict(arch=a, mesh=(1, 4))) for a in THREE]
BOUNDED4 = ([(f"2x2/{a}", dict(arch=a, mesh=(2, 2))) for a in THREE]
            + [("2x2/mb2/mixtral-8x7b", dict(arch="mixtral-8x7b",
                                              mesh=(2, 2), microbatches=2))])
CKPT_STEP = 4

JAX_TRAINER = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    import repro.train.trainer as jtrainer
    from repro.configs import get_smoke
    from repro.data import pipeline as jpipe
    from repro.optim import adamw as jadamw
    from repro.sharding.rules import make_rules
    from repro_torch.configs import get_smoke as port_smoke
    from repro_torch.models.schema import init_numpy
    tree = init_numpy(port_smoke("smollm-360m"), 3)
    jtrainer.init_params = lambda cfg, key: jax.tree.map(jnp.asarray, tree)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    cfg = get_smoke("smollm-360m").replace(compute_dtype="float32")
    t = jtrainer.Trainer(
        cfg, jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8),
        jtrainer.TrainConfig(steps=4, save_every=2, microbatches=2, seed=3,
                             ckpt_dir=sys.argv[1]),
        jpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                         global_batch=4), rules=make_rules(mesh))
    t.run()
    print(json.dumps([m["loss"] for m in t.metrics_log]))
""")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One world of ranks per mesh shape, (1, 2) and (2, 1) of 2 ranks and
    (1, 4) with (2, 2) of 4, and the JAX Trainer's subprocess, all at once
    (the restores wait for the 4-rank Trainer's checkpoint)."""
    tmp = tmp_path_factory.mktemp("worlds")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_TRAINER, str(tmp / "jax_ckpt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ckpt = tmp / "ckpt"
    jobs4 = [(name, "steps", kw) for name, kw in EXACT4 + BOUNDED4]
    jobs4.append(("trainer", "trainer", dict(
        arch="smollm-360m", mesh=(2, 2), ckpt_dir=str(ckpt))))

    def on(mesh):
        return [(name, "steps", kw) for name, kw in EXACT + BOUNDED
                if kw["mesh"] == mesh]

    def restore(mesh):
        return ("restore", dict(arch="smollm-360m", mesh=mesh,
                                ckpt_dir=str(ckpt), step=CKPT_STEP))
    jobs12 = on((1, 2)) + [("restore/1x2", *restore((1, 2))), (
        "resume/1x2", "resume", dict(
            arch="smollm-360m", mesh=(1, 2), ckpt_dir=str(ckpt),
            step=CKPT_STEP, out_dir=str(tmp / "resume")))]
    jobs21 = on((2, 1)) + [("restore/2x1", *restore((2, 1)))]
    try:
        started = [ranks.start(4, jobs4, tmp / "world4"),
                   ranks.start(2, jobs12, tmp / "world12"),
                   ranks.start(2, jobs21, tmp / "world21")]
        res = {}
        for world in started:
            res.update(ranks.collect(world))
        out, err = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.communicate()
    assert jax_run.returncode == 0, err[-4000:]
    res["jax_losses"] = json.loads(out.strip().splitlines()[-1])
    res["ckpt"] = ckpt
    return res


def _states(res):
    return res["sharded"]["state"], res["one_device"]["state"]


@pytest.mark.parametrize("name", [n for n, _ in EXACT + EXACT4])
def test_data_extent_1_bit_identical(worlds, name):
    res = worlds[name]
    got, want = _states(res)
    assert res["sharded"]["metrics"] == res["one_device"]["metrics"]
    for a, b in zip(res["sharded"]["grads"], res["one_device"]["grads"],
                    strict=True):
        assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
    assert got["step"] == want["step"] == 3
    for key in ("params", "m", "v"):
        assert list(got[key]) == list(want[key])
        differ = [n for n in want[key]
                  if not torch.equal(got[key][n], want[key][n])]
        assert not differ, (key, differ[:4])


def _close_scaled(got, want, tol, what):
    want, got = want.float().numpy(), got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", [n for n, _ in BOUNDED + BOUNDED4])
def test_data_parallel_within_bounds(worlds, name):
    res = worlds[name]
    got, want = _states(res)
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


@pytest.mark.parametrize("name", [n for n, _ in EXACT + BOUNDED + EXACT4
                                  + BOUNDED4])
def test_every_shard_is_the_global_size_over_its_extents(worlds, name):
    numel = worlds[name]["sharded"]["numel"]
    assert numel and all(local * extents == whole
                         for local, whole, extents in numel.values())
    if "1x2/" in name or "1x4/" in name:       # "model" shards something
        assert any(local < whole for local, whole, _ in numel.values())


def test_checkpoint_restores_across_meshes(worlds):
    saved = worlds["trainer"]["state"]
    params, opt, man = checkpoint.restore(worlds["ckpt"], CKPT_STEP, "cpu")
    assert man["step"] == CKPT_STEP and int(opt["step"]) == CKPT_STEP
    for key, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
        assert set(tree) == set(saved[key])
        assert all(torch.equal(tree[n], saved[key][n]) for n in tree), key
    for mesh in ("1x2", "2x1"):
        res = worlds[f"restore/{mesh}"]
        assert res["blocks_are_parts"], mesh
        got = res["state"]
        assert got["step"] == CKPT_STEP
        for key in ("params", "m", "v"):
            assert set(got[key]) == set(saved[key])
            assert all(torch.equal(got[key][n], saved[key][n])
                       for n in saved[key]), (mesh, key)


def test_elastic_resume_bit_identical(worlds):
    """The (2, 2) checkpoint of step 4 resumed to step 6 by the Trainer
    on (1, 2) and by the one-device Trainer: equal bit for bit."""
    res = worlds["resume/1x2"]
    got, want = res["sharded"], res["one_device"]
    assert got["step"] == want["step"] == 6
    for key in ("params", "m", "v"):
        assert set(got[key]) == set(want[key])
        differ = [n for n in want[key]
                  if not torch.equal(got[key][n], want[key][n])]
        assert not differ, (key, differ[:4])


def test_the_trainer_matches_the_jax_trainer(worlds):
    losses = worlds["trainer"]["losses"]
    assert len(losses) == 4
    np.testing.assert_allclose(losses, worlds["jax_losses"], rtol=1e-6)
