"""The port's data pipeline, checkpoints, Trainer, MeshPlanner and
training launcher, on the CPU, against the JAX package where it has a
counterpart.

Data batches are byte-identical (both are numpy); MeshPlanner's plans and
estimates equal the reference's field for field (the port's H100
constants patched to the reference's in the test); the two Trainers,
started from one set of numpy-seeded params at f32 compute, log per-step
losses within 1e-6 relative; checkpoints round-trip bit for bit, bf16
included, and a resumed run equals an uninterrupted one bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train.trainer as jtrainer
from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.core import meshplanner as jmp
from repro.data import pipeline as jpipe
from repro.models.config import SHAPES as JSHAPES
from repro.optim import adamw as jadamw
from repro.roofline import analysis as janalysis
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import meshplanner as mp
from repro_torch.data import pipeline as pipe
from repro_torch.launch import train as launch
from repro_torch.models.config import SHAPES
from repro_torch.models.schema import init_numpy
from repro_torch.optim import adamw
from repro_torch.roofline import analysis
from repro_torch.train import checkpoint
from repro_torch.train.trainer import Trainer, TrainConfig


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _same_batches(port_src, ref_src, steps):
    for step in steps:
        a, b = port_src.batch_at(step), ref_src.batch_at(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (step, k)


@pytest.mark.parametrize("hosts", [1, 2])
def test_synthetic_batches_byte_identical(hosts):
    for host in range(hosts):
        kw = dict(vocab_size=503, seq_len=64, global_batch=8, seed=7,
                  host_index=host, host_count=hosts)
        _same_batches(pipe.SyntheticLM(pipe.DataConfig(**kw)),
                      jpipe.SyntheticLM(jpipe.DataConfig(**kw)),
                      [0, 1, 2, 17, 1000])


def test_bin_corpus_batches_byte_identical(tmp_path):
    g = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((700, 1300, 90)):
        path = tmp_path / f"shard{i}.bin"
        g.integers(0, 1 << 20, n).astype(np.int32).tofile(path)
        paths.append(path)
    for host in range(2):
        kw = dict(vocab_size=1000, seq_len=48, global_batch=4,
                  host_index=host, host_count=2)
        port = pipe.make_source(pipe.DataConfig(**kw), paths)
        assert isinstance(port, pipe.BinCorpus)
        _same_batches(port, jpipe.make_source(jpipe.DataConfig(**kw), paths),
                      range(12))


def test_to_device_keeps_the_bytes():
    b = pipe.SyntheticLM(pipe.DataConfig(100, 16, 2)).batch_at(3)
    t = pipe.to_device(b, "cpu")
    for k in b:
        assert t[k].dtype == torch.int32
        np.testing.assert_array_equal(t[k].numpy(), b[k])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_bf16_and_opt(tmp_path):
    g = torch.Generator().manual_seed(0)
    params = {"a.w": torch.randn(4, 3, generator=g),
              "b": torch.randn(5, generator=g).to(torch.bfloat16)}
    opt = adamw.init(params)
    opt.step.fill_(7)
    opt.m["a.w"].normal_(generator=g)
    checkpoint.save(tmp_path, 5, params, opt, {"arch": "x"})
    assert checkpoint.latest_step(tmp_path) == 5
    p2, o2, man = checkpoint.restore(tmp_path, 5, "cpu")
    assert man["step"] == 5 and man["arch"] == "x"
    assert man["dtypes"]["params/b"] == "bfloat16"
    for k, t in params.items():
        assert p2[k].dtype == t.dtype and torch.equal(p2[k], t)
    st = adamw.AdamWState(**o2)
    assert st.step.dtype == torch.int32 and int(st.step) == 7
    for k in params:
        assert torch.equal(st.m[k], opt.m[k]) and torch.equal(st.v[k],
                                                              opt.v[k])


def test_checkpoint_atomicity(tmp_path):
    """A leftover .tmp dir from a crashed save is never picked up, and a
    save over it completes."""
    params = {"w": torch.ones(3)}
    checkpoint.save(tmp_path, 1, params)
    (tmp_path / "step_00000009.tmp").mkdir()
    assert checkpoint.latest_step(tmp_path) == 1
    (tmp_path / "step_00000004").mkdir()          # no manifest: incomplete
    assert checkpoint.latest_step(tmp_path) == 1
    checkpoint.save(tmp_path, 9, params)
    assert checkpoint.latest_step(tmp_path) == 9
    assert not (tmp_path / "step_00000009.tmp").exists()
    assert checkpoint.latest_step(tmp_path / "none") is None


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _smoke(arch="smollm-360m", **kw):
    return get_smoke(arch).replace(use_kernels=False, **kw)


def test_trainer_resume_bit_identical(tmp_path):
    cfg = _smoke()
    hp = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=12)
    dc = pipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                         global_batch=4)

    def tc(d, **kw):
        return TrainConfig(steps=8, save_every=4, ckpt_dir=str(tmp_path / d),
                           **kw)
    r1 = Trainer(cfg, hp, tc("a"), dc, "cpu").run()
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        Trainer(cfg, hp, tc("b", fail_at_step=6), dc, "cpu").run()
    assert checkpoint.latest_step(tmp_path / "b") == 4
    t2 = Trainer(cfg, hp, tc("b"), dc, "cpu")
    r2 = t2.run()
    assert [m["step"] for m in t2.metrics_log] == [5, 6, 7, 8]
    for (n, x), (_, y) in zip(r1["model"].named_parameters(),
                              r2["model"].named_parameters()):
        assert torch.equal(x, y), n
    for k in r1["opt"].m:
        assert torch.equal(r1["opt"].m[k], r2["opt"].m[k])
        assert torch.equal(r1["opt"].v[k], r2["opt"].v[k])
    assert int(r2["opt"].step) == 8


def test_training_loss_decreases(tmp_path):
    cfg = _smoke()
    hp = adamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=25)
    dc = pipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                         global_batch=8)
    t = Trainer(cfg, hp, TrainConfig(steps=20, save_every=20,
                                     ckpt_dir=str(tmp_path)), dc, "cpu")
    t.run()
    losses = [m["loss"] for m in t.metrics_log]
    assert losses[-1] < losses[0] * 0.9


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_trainer_matches_the_jax_trainer(arch, tmp_path, monkeypatch):
    """Four steps of each package's Trainer (2 microbatches, a save at
    step 2) from one set of numpy-seeded params at f32 compute. Both
    Trainers feed token batches, which HuBERT (frame embeddings, no
    token embedding) cannot take: there both refuse the first step."""
    cfg = _smoke(arch, compute_dtype="float32")
    jcfg = jax_smoke(arch).replace(compute_dtype="float32")
    tree = init_numpy(cfg, 3)
    monkeypatch.setattr(jtrainer, "init_params",
                        lambda _cfg, _key: jax.tree.map(jnp.asarray, tree))
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    dkw = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tkw = dict(steps=4, save_every=2, microbatches=2, seed=3)
    jt = jtrainer.Trainer(jcfg, jadamw.AdamWConfig(**kw),
                          jtrainer.TrainConfig(ckpt_dir=str(tmp_path / "j"),
                                               **tkw),
                          jpipe.DataConfig(**dkw))
    t = Trainer(cfg, adamw.AdamWConfig(**kw),
                TrainConfig(ckpt_dir=str(tmp_path / "t"), **tkw),
                pipe.DataConfig(**dkw), "cpu")
    if cfg.frontend == "audio_frames":
        with pytest.raises(KeyError, match="embed"):
            jt.run()
        with pytest.raises(ValueError, match="no token embedding"):
            t.run()
        return
    jt.run()
    t.run()
    assert [m["step"] for m in t.metrics_log] == [1, 2, 3, 4]
    np.testing.assert_allclose([m["loss"] for m in t.metrics_log],
                               [m["loss"] for m in jt.metrics_log], rtol=1e-6)
    assert checkpoint.latest_step(tmp_path / "t") == 4


# ---------------------------------------------------------------------------
# MeshPlanner
# ---------------------------------------------------------------------------

def test_h100_constants():
    """The data sheet's H100 SXM figures, not the reference's TPU ones."""
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW,
            analysis.HBM_PER_CHIP) == (989e12, 3.35e12, 900e9, 80e9)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate(arch):
    for name, shape in SHAPES.items():
        assert analysis.model_flops_estimate(get_config(arch), shape) == \
            janalysis.model_flops_estimate(jax_config(arch), JSHAPES[name])


def _plain(plan):
    d = dataclasses.asdict(plan)
    for entry in d["map_log"]:
        entry["action"] = entry["action"].replace(
            "enable the flash_attention kernel (scores stay on chip)",
            "enable Pallas flash attention (scores stay in VMEM)")
    return d


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("n_devices,tp", [(1, 1), (8, 4), (256, 16)])
def test_meshplanner_equals_the_reference(arch, n_devices, tp, monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(mp, name, getattr(janalysis, name))
    budget = janalysis.HBM_PER_CHIP
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    for name, shape in SHAPES.items():
        assert mp.cell_supported(cfg, shape) == jmp.cell_supported(
            jcfg, JSHAPES[name])
        for knobs in (mp.Knobs(), mp.Knobs(remat="full", fsdp=False,
                                           use_flash_kernel=True,
                                           microbatches=4)):
            got = mp.estimate(cfg, shape, knobs, n_devices, tp)
            want = jmp.estimate(jcfg, JSHAPES[name],
                                jmp.Knobs(**dataclasses.asdict(knobs)),
                                n_devices, tp)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.bound() == want.bound()
        for target in (None, 1e-4):
            got = mp.plan(cfg, shape, n_devices=n_devices, tp=tp,
                          hbm_budget=budget, step_target_s=target)
            want = jmp.plan(jcfg, JSHAPES[name], n_devices=n_devices, tp=tp,
                            hbm_budget=budget, step_target_s=target)
            assert _plain(got) == dataclasses.asdict(want), (name, target)


def test_knobs_apply_sets_use_kernels():
    cfg = get_config("smollm-360m")
    assert cfg.use_kernels
    out = mp.Knobs(remat="dots", attn_q_chunk=128).apply(cfg)
    assert (out.remat, out.attn_q_chunk, out.use_kernels) == ("dots", 128,
                                                              False)
    assert mp.Knobs(use_flash_kernel=True).apply(cfg).use_kernels


def test_one_card_plan_of_the_full_width_launch():
    """The card's plan for SmolLM-360M at (8, 2048): dots, one microbatch,
    under 80 GB."""
    from repro_torch.models.config import ShapeSpec
    plan = mp.plan(get_config("smollm-360m"),
                   ShapeSpec("launch", 2048, 8, "train"))
    assert plan.fits and plan.knobs.remat == "dots"
    assert plan.knobs.microbatches == 1
    assert plan.estimate.total_bytes < analysis.HBM_PER_CHIP


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_on_the_cpu(tmp_path, capsys):
    out = launch.main(["--arch", "smollm-360m", "--steps", "3",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "device: cpu" in printed
    assert "plan: remat=dots microbatches=1" in printed
    assert "final loss" in printed
    assert np.isfinite(out["final_loss"]) and out["steps"] == 3
    assert out["plan"].knobs.remat == "dots"
    assert not out["trainer"].cfg.use_kernels
    assert checkpoint.latest_step(tmp_path) == 3


def test_launch_train_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert checkpoint.latest_step(tmp_path) is None
