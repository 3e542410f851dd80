"""The golden file of the port's on-card training check.

``src/repro_torch/train/golden_train.json`` holds what the JAX package's
``make_train_step`` gives for ``chip_smoke.py``'s golden training run:
SmolLM-360M at full width cut to 4 layers, f32 compute, remat "dots",
numpy-seeded weights (``repro_torch.models.schema.init_numpy``), 4 AdamW
steps of ``SyntheticLM`` batches (seq 256, batch 4, seed 1234) in 2
microbatches. It keeps the batches themselves (numpy's zipf draws other
tokens under other numpy versions), per step loss, grad_norm and lr, and
per final parameter (by the port's name) its size, sum and largest |x|.
The card's run is held to it without JAX on that machine.

These tests keep the file complete and consistent with ``chip_smoke.py``
and hold the port's CPU run of the recipe to it within
``chip_smoke.TRAIN_GOLDEN_TOL``, whose planted faults must fall outside;
running this file as a script regenerates the file from the JAX package
on the CPU (about 3 GB of memory, under a minute on 8 cores):

    PYTHONPATH=src python tests/test_torch_train_golden.py
"""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models.steps import make_train_step as jax_train_step
from repro.optim import adamw as jadamw
from repro_torch.convert import params_from_reference
from repro_torch.models.schema import init_numpy

ROOT = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_chip_smoke()


def jax_golden_config():
    """The JAX twin of ``chip_smoke.train_config(golden=True)``."""
    ours = dataclasses.asdict(smoke.train_config(golden=True))
    assert ours.pop("use_kernels") is False
    cfg = jax_config(smoke.TRAIN_ARCH).replace(
        n_layers=smoke.GOLDEN_TRAIN_LAYERS, compute_dtype="float32",
        remat="dots")
    theirs = dataclasses.asdict(cfg)
    assert theirs.pop("use_pallas") is False
    assert ours == {k: theirs[k] for k in ours}
    return cfg


def jax_batches() -> list:
    data = JaxSyntheticLM(JaxDataConfig(jax_golden_config().vocab_size,
                                        **smoke.GOLDEN_TRAIN_DATA))
    return [data.batch_at(s) for s in range(smoke.GOLDEN_TRAIN_STEPS)]


def jax_record() -> dict:
    """The golden run through the JAX package on the CPU."""
    cfg = jax_golden_config()
    port_cfg = smoke.train_config(golden=True)
    tree = init_numpy(port_cfg, smoke.TRAIN_SEED)
    step = jax.jit(jax_train_step(cfg, jadamw.AdamWConfig(
        **smoke.GOLDEN_TRAIN_HP), microbatches=smoke.GOLDEN_TRAIN_MICROBATCHES))
    params = jax.tree.map(jnp.asarray, tree)
    opt = jadamw.init(params)
    steps = []
    for batch in jax_batches():
        params, opt, m = step(params, opt, jax.tree.map(jnp.asarray, batch))
        steps.append({k: float(v) for k, v in sorted(m.items())})
    final = params_from_reference(jax.tree.map(np.asarray, params), port_cfg,
                                  "cpu")
    return {"steps": steps, "tensors": smoke.tensor_summary(
        (n, p.detach().numpy()) for n, p in final.named_parameters())}


def test_golden_file_is_complete_and_matches_the_smoke_run():
    golden = json.loads(smoke.GOLDEN_TRAIN.read_text())
    assert golden["spec"] == smoke.train_golden_spec()
    jax_golden_config()
    assert len(golden["steps"]) == len(golden["batches"]) \
        == smoke.GOLDEN_TRAIN_STEPS
    for row in golden["steps"]:
        assert set(row) == {"loss", "grad_norm", "lr"}
        assert all(np.isfinite(v) and v > 0 for v in row.values())
    names = [n for n, _ in smoke.init_model(smoke.train_config(golden=True),
                                            0, "cpu").named_parameters()]
    assert list(golden["tensors"]) == names
    assert set(smoke.TRAIN_GOLDEN_TOL) == {"loss_rel", "grad_norm_rel",
                                           "lr_rel", "sum_err",
                                           "max_abs_rel"}


def test_golden_batches_are_the_pipelines():
    """With this installation's numpy the file's batches are what both
    packages' SyntheticLM make for the golden run."""
    golden = json.loads(smoke.GOLDEN_TRAIN.read_text())
    assert smoke.golden_train_batches() == golden["batches"]
    assert [{k: v.tolist() for k, v in b.items()} for b in jax_batches()] \
        == golden["batches"]


@pytest.fixture(scope="module")
def golden():
    return json.loads(smoke.GOLDEN_TRAIN.read_text())


@pytest.fixture(scope="module")
def cpu_record(golden):
    return smoke.train_golden_record("cpu", golden["batches"])


def test_the_port_on_the_cpu_is_within_the_limit(golden, cpu_record):
    errs = smoke.train_golden_errs(cpu_record, golden)
    assert not smoke._train_golden_over(errs), errs


@pytest.mark.parametrize("fault", smoke.TRAIN_FAULTS, ids=lambda f: f[0])
def test_planted_faults_fall_outside_the_limit(golden, fault):
    record = smoke._planted(fault, smoke.train_golden_record, "cpu",
                            golden["batches"])
    errs = smoke.train_golden_errs(record, golden)
    assert smoke._train_golden_over(errs), (fault[0], errs)


if __name__ == "__main__":
    record = jax_record()
    batches = [{k: v.tolist() for k, v in b.items()} for b in jax_batches()]
    out = {"spec": smoke.train_golden_spec(), "batches": "@", **record}
    # the batches on one line, the rest one value a line
    text = json.dumps(out, indent=1).replace('"batches": "@"', '"batches": '
                                             + json.dumps(batches), 1)
    smoke.GOLDEN_TRAIN.write_text(text + "\n")
    print(f"wrote {smoke.GOLDEN_TRAIN} ({len(record['tensors'])} tensors)",
          file=sys.stderr)
