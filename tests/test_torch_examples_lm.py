"""The port's LM examples against the JAX package's, on the CPU, at f32
compute (each example's config ``.replace(compute_dtype="float32")``,
patched into both scripts).

* ``examples/torch_quickstart.py`` and ``examples/torch_train_lm.py``
  (``train_lm`` at ``--steps 4 --d-model 64 --layers 2 --heads 2
  --seq-len 32 --batch 4 --vocab 256``) against ``examples/quickstart.py``
  and ``examples/train_lm.py``: both Trainers start from one set of
  numpy-seeded params (the reference's ``init_params`` patched to
  ``schema.init_numpy(cfg, 0)``, which the port's Trainer draws), each
  run checkpoints into a directory of its own (the reference's
  ``TrainConfig.ckpt_dir`` patched), per-step losses within 1e-6
  relative, quickstart's greedy tokens equal.
* ``train_lm`` stopped at step 3 and started again ends bit for bit as
  an uninterrupted run (``chip_smoke.train_lm_entry``, phase 8c's check).
* ``examples/torch_serve_decode.py``'s LLM leg against
  ``examples/serve_decode.py``'s at ``--temperature 0`` from the
  reference's own ``init_params(cfg, PRNGKey(0))`` weights, passed to the
  port as ``params=``: the printed tokens equal. At the default
  temperature 0.8 the port samples from a ``torch.Generator`` (not the
  reference's ``jax.random``): one seed gives the same tokens twice, all
  in range.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.train.trainer as jtrainer
from repro.models.schema import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.schema import init_numpy

from _examples import one_thread, port_module, reference_module  # noqa: F401
from _examples import run_port as _run_port
from _examples import run_reference as _run_reference
from _examples import smoke

CPU = torch.device("cpu")
TRAIN_LM_ARGV = list(smoke.TRAIN_LM_ARGV)


def port_config(jcfg) -> ModelConfig:
    """The port's twin of a reference ModelConfig."""
    fields = dataclasses.asdict(jcfg)
    fields.pop("use_pallas")
    return ModelConfig(**fields)


def f32(get):
    return lambda arch: get(arch).replace(compute_dtype="float32")


class Recorded(jtrainer.Trainer):
    """The reference Trainer, keeping each instance for its metrics."""
    runs: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        Recorded.runs.append(self)


def run_reference(script: str, argv, monkeypatch, ckpt_dir=None) -> str:
    """examples/<script>.py in this process at f32 compute, from the
    port's numpy-seeded params (checkpoints into ``ckpt_dir``)."""
    mod = reference_module(script)
    for name in ("get_smoke", "get_config"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, f32(getattr(mod, name)))
    monkeypatch.setattr(jtrainer, "init_params", lambda cfg, key: jax.tree.map(
        jax.numpy.asarray, init_numpy(port_config(cfg), 0)))
    if hasattr(mod, "TrainConfig"):
        tc = mod.TrainConfig
        monkeypatch.setattr(mod, "TrainConfig", lambda **kw: tc(
            **{**kw, "ckpt_dir": str(ckpt_dir)}))
        monkeypatch.setattr(mod, "Trainer", Recorded)
    Recorded.runs = []
    return _run_reference(script, argv, mod)


def run_port(script: str, argv, monkeypatch, **kw) -> tuple:
    mod = port_module(script)
    for name in ("get_smoke", "get_config"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, f32(getattr(mod, name)))
    return _run_port(script, argv, mod, **kw)


def _losses(trainer) -> list:
    return [m["loss"] for m in trainer.metrics_log]


def test_quickstart_equals_the_reference(tmp_path, monkeypatch):
    text = run_reference("quickstart", [], monkeypatch, tmp_path / "ref")
    (ref,) = Recorded.runs
    out, port_text = run_port("quickstart", ["--ckpt-dir",
                                             str(tmp_path / "port")],
                              monkeypatch)
    assert len(out["losses"]) == 40
    np.testing.assert_allclose(out["losses"], _losses(ref), rtol=1e-6)
    want = re.search(r"^generated: (.*)$", text, re.M).group(1)
    assert str(out["generated"]) == want
    assert f"generated: {want}" in port_text.splitlines()
    assert port_text.splitlines()[0] == text.splitlines()[0]    # arch line


def test_train_lm_equals_the_reference(tmp_path, monkeypatch):
    text = run_reference("train_lm", TRAIN_LM_ARGV, monkeypatch,
                         tmp_path / "ref")
    (ref,) = Recorded.runs
    out, port_text = run_port(
        "train_lm", TRAIN_LM_ARGV + ["--ckpt-dir", str(tmp_path / "port")],
        monkeypatch)
    assert out["steps"] == [1, 2, 3, 4]
    np.testing.assert_allclose(out["losses"], _losses(ref), rtol=1e-6)
    assert port_text.splitlines()[0] == text.splitlines()[0]    # params


def test_train_lm_resumes_bit_for_bit():
    rec = smoke.train_lm_entry(CPU)
    assert rec["resumed_from"] == smoke.TRAIN_LM_SAVE_EVERY
    assert rec["resume_bit_identical"], rec["resume"]
    assert rec["resumed_losses"] == rec["losses"][smoke.TRAIN_LM_SAVE_EVERY:]


def test_serve_decode_greedy_equals_the_reference(monkeypatch):
    argv = ["--max-new", "4", "--temperature", "0"]
    monkeypatch.setattr(jconfigs, "get_smoke", f32(jconfigs.get_smoke))
    text = _run_reference("serve_decode", argv)
    jcfg = jconfigs.get_smoke("granite-8b")
    tree = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    outs, port_text = run_port("serve_decode", argv, monkeypatch,
                               params=tree)
    assert port_text.splitlines() == text.splitlines()
    assert len(outs) == 4 and all(len(o) > 4 for o in outs)


def test_serve_decode_sampling_is_seeded():
    mod = port_module("serve_decode")
    a, text = _run_port("serve_decode", ["--max-new", "4"], mod)
    b, _ = _run_port("serve_decode", ["--max-new", "4"], mod)
    assert a == b
    vocab = mod.get_smoke("granite-8b").vocab_size
    assert all(0 <= t < vocab for row in a for t in row)
    assert len(text.splitlines()) == 4


def test_the_card_is_the_default(tmp_path, monkeypatch):
    """Without --device the LM examples run on the card; on a host
    without one they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for script, argv in (("quickstart", ["--ckpt-dir", str(tmp_path)]),
                         ("train_lm", TRAIN_LM_ARGV),
                         ("serve_decode", ["--max-new", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            smoke.captured(port_module(script).main, argv)


def test_flash_calls_are_held_to_the_plain_attention():
    """Phase 8c records the LM examples' own flash_attention calls and
    holds each against attention_ref on its inputs (on the CPU the
    wrapper is that plain version); an output one step off fails."""
    rec = smoke.serve_llm_entry(CPU)
    assert {k: w["calls"] for k, w in rec["flash_calls"].items()} == {
        "12x6x4x4x16/c1/w0/bfloat16": 4, "4x2x1x1x16/c1/w0/bfloat16": 4}
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, 5, 16, generator=gen).to(torch.bfloat16)
               for s in (4, 2, 2))
    kw = {"causal": True, "window": 0, "scale": 0.0}
    with smoke.recorded_flash() as calls:
        out = smoke.fa.flash_attention(q, k, v, **kw)
    assert smoke.check_flash_calls("cpu", calls)["4x2x5x5x16/c1/w0/bfloat16"][
        "max_abs_err"] == 0.0
    calls[0] = (q, k, v, kw, out + 0.25 * out.abs().amax())
    with pytest.raises(RuntimeError, match="flash_attention 4x2x5x5x16"):
        smoke.check_flash_calls("cpu", calls)
