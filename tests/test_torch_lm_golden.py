"""The golden file of the port's on-card LM run.

``src/repro_torch/models/golden_lm.json`` holds what the JAX package's
``Engine.generate`` gives for ``chip_smoke.py``'s LM golden run:
RecurrentGemma-2B at full width, 3 layers, f32 compute, numpy-seeded
weights (``repro_torch.models.schema.init_numpy``), six seeded prompts in
two waves of 4 slots, 16 greedy tokens each. Per prompt it keeps the
generated tokens, the top-1/top-2 margin of the logits behind each, and
the top-8 ids and values of the prefill logits. The card's run is held to
it without JAX on that machine.

These tests keep the file complete and consistent with ``chip_smoke.py``,
and check the recording on a SMOKE model; running this file as a script
regenerates the file from the JAX package on the CPU (about 6 GB of
memory, under a minute on 8 cores):

    PYTHONPATH=src python tests/test_torch_lm_golden.py
"""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.models.config import ModelConfig as JaxConfig
from repro.serve.llm import Engine as JaxEngine
from repro.serve.llm import EngineConfig as JaxEngineConfig
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_reference
from repro_torch.models.schema import init_numpy
from repro_torch.serve.llm import Engine, EngineConfig

ROOT = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_chip_smoke()


def jax_golden_config() -> JaxConfig:
    """The JAX twin of ``chip_smoke.lm_config(golden=True)``, on the
    reference's plain path (``use_pallas=False``)."""
    ours = dataclasses.asdict(smoke.lm_config(golden=True))
    ours.pop("use_kernels")
    cfg = jax_config(smoke.LM_ARCH).replace(
        n_layers=smoke.GOLDEN_LM_LAYERS, compute_dtype="float32")
    theirs = dataclasses.asdict(cfg)
    assert theirs.pop("use_pallas") is False
    assert ours == {k: theirs[k] for k in ours}
    return cfg


def test_golden_file_is_complete_and_matches_the_smoke_run():
    golden = json.loads(smoke.GOLDEN_LM.read_text())
    assert golden["spec"] == smoke.golden_spec()
    jax_golden_config()
    assert len(golden["prompts"]) == len(smoke.LM_LENGTHS)
    for row in golden["prompts"]:
        assert len(row["tokens"]) == len(row["margins"]) == smoke.LM_MAX_NEW
        assert len(row["prefill_top_ids"]) == smoke.LM_TOPK
        vals = row["prefill_top_vals"]
        assert vals == sorted(vals, reverse=True)
        assert row["tokens"][0] == row["prefill_top_ids"][0]
        assert all(m >= 0 for m in row["margins"])


def test_prompts_are_seeded_and_sized():
    a = smoke.lm_prompts(256_000)
    assert a == smoke.lm_prompts(256_000)
    assert [len(p) for p in a] == list(smoke.LM_LENGTHS)
    assert all(0 <= t < 256_000 for p in a for t in p)


def test_recording_on_a_smoke_model_agrees_across_packages():
    """The golden file's recipe at SMOKE size: recording changes nothing
    the engine returns, and the summaries of the port and the reference
    agree (tokens equal where the margin allows, top-k values to 1e-4)."""
    cfg = get_smoke(smoke.LM_ARCH).replace(compute_dtype="float32")
    jcfg = jax_smoke(smoke.LM_ARCH).replace(compute_dtype="float32")
    tree = init_numpy(cfg, 0)
    model = params_from_reference(tree, cfg, "cpu")
    g = np.random.default_rng(0)
    prompts = [[int(t) for t in g.integers(0, cfg.vocab_size, n)]
               for n in (30, 5, 17, 9, 12, 3)]
    ecfg = dict(slots=smoke.LM_SLOTS)
    port = Engine(cfg, model, EngineConfig(**ecfg))
    out, calls = smoke.record_generate(port, prompts, smoke.LM_MAX_NEW)
    assert out == port.generate(prompts, smoke.LM_MAX_NEW)
    ref = JaxEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                    JaxEngineConfig(**ecfg))
    jout, jcalls = smoke.record_generate(ref, prompts, smoke.LM_MAX_NEW)
    mine = smoke.summarize(out, calls, prompts)
    theirs = smoke.summarize(jout, jcalls, prompts)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        np.testing.assert_allclose(a["prefill_top_vals"],
                                   b["prefill_top_vals"], atol=1e-4)
        assert smoke._matched_steps(a["tokens"], b["tokens"], b["margins"],
                                    1e-4, f"prompt {i}") > 0


def test_teacher_forcing_feeds_the_reference_tokens():
    """``record_generate(forced=...)``, as the card's kernel-vs-plain
    comparison uses it: each call returns the forced tokens, and a run
    forced with its own tokens repeats its logits exactly."""
    cfg = get_smoke(smoke.LM_ARCH).replace(compute_dtype="float32")
    model = params_from_reference(init_numpy(cfg, 1), cfg, "cpu")
    g = np.random.default_rng(1)
    prompts = [[int(t) for t in g.integers(0, cfg.vocab_size, n)]
               for n in (20, 3, 9, 14, 6)]
    engine = Engine(cfg, model, EngineConfig(slots=smoke.LM_SLOTS))
    _, free = smoke.record_generate(engine, prompts, smoke.LM_MAX_NEW)
    _, again = smoke.record_generate(engine, prompts, smoke.LM_MAX_NEW,
                                     forced=[c[1] for c in free])
    assert len(again) == len(free) == 2 * smoke.LM_MAX_NEW
    for a, b in zip(again, free):
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[0], b[0])
    other = [[(t + 1) % cfg.vocab_size for t in c[1]] for c in free]
    out, forced = smoke.record_generate(engine, prompts, smoke.LM_MAX_NEW,
                                        forced=other)
    assert [c[1] for c in forced] == other
    for i, row in enumerate(out):
        wave, r = divmod(i, smoke.LM_SLOTS)
        steps = other[wave * smoke.LM_MAX_NEW:(wave + 1) * smoke.LM_MAX_NEW]
        assert row[len(prompts[i]):] == [s[r] for s in steps]


def _to_jax(tree):
    """Move a numpy tree into JAX leaf by leaf, dropping each numpy leaf
    as it goes (the golden model is ~6 GB)."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            _to_jax(tree[k])
        else:
            tree[k] = jnp.asarray(tree.pop(k))
    return tree


def main() -> None:
    jcfg = jax_golden_config()
    tree = _to_jax(init_numpy(smoke.lm_config(golden=True), smoke.LM_SEED))
    prompts = smoke.lm_prompts(jcfg.vocab_size)
    engine = JaxEngine(jcfg, tree, JaxEngineConfig(slots=smoke.LM_SLOTS))
    out, calls = smoke.record_generate(engine, prompts, smoke.LM_MAX_NEW)
    golden = {"spec": smoke.golden_spec(),
              "prompts": smoke.summarize(out, calls, prompts)}
    for i, row in enumerate(golden["prompts"]):
        print(i, row["tokens"], f"min margin {min(row['margins']):.4g}",
              file=sys.stderr, flush=True)
    smoke.GOLDEN_LM.write_text(json.dumps(golden, indent=1) + "\n")


if __name__ == "__main__":
    main()
