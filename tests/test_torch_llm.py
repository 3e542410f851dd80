"""The port's serving path against the JAX package's, on the CPU:
``Engine.generate`` (prefill + greedy decode, slot waves) on the
RecurrentGemma and SmolLM SMOKE configs, weights carried across by
``convert.params_from_reference``, and on the SMOKE configs of the MoE
family (Mixtral, with its window, and Llama-4-Scout), the dense
Granite and Qwen1.5 ones (QKV bias), xLSTM-350M (mLSTM and sLSTM
states through left-padded waves) and Qwen2-VL-72B (M-RoPE, every stream
on the token positions). Prompts are longer and shorter than
the SMOKE window of 16 and come in two waves, so the window cache takes
both of its branches and ring decode crosses the wrap.

Tolerances: the logits of every prefill and decode step 1e-4 at f32
compute (about 1e-6 is seen; sums in another order through 5 layers),
greedy tokens equal. At bf16 compute the two frameworks round at other
places: prefill logits 0.1 (bf16 keeps ~3 digits of logits of magnitude
~1, through 5 layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import model as JM
from repro.models.schema import init_params
from repro.serve.llm import Engine as JaxEngine
from repro.serve.llm import EngineConfig as JaxEngineConfig
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.convert import init_model, params_from_reference
from repro_torch.models import model as M
from repro_torch.models.schema import init_numpy
from repro_torch.serve.llm import Engine, EngineConfig
from repro_torch.serve.scheduler import plan_waves

LENGTHS = (30, 5, 17, 9, 12)            # waves of 3: [30, 5, 17], [9, 12]


def _prompts(vocab, lengths=LENGTHS, seed=0):
    g = np.random.default_rng(seed)
    return [[int(t) for t in g.integers(0, vocab, n)] for n in lengths]


def _pair(arch, use_kernels, dtype="float32", seed=0):
    cfg = get_smoke(arch).replace(compute_dtype=dtype,
                                  use_kernels=use_kernels)
    jcfg = jax_smoke(arch).replace(compute_dtype=dtype,
                                   use_pallas=use_kernels)
    tree = init_numpy(cfg, seed)
    return cfg, params_from_reference(tree, cfg, "cpu"), jcfg, \
        jax.tree.map(jnp.asarray, tree)


def _wave_logits(cfg, model, jcfg, jparams, prompts):
    """Last-token prefill logits of the first wave, left-padded, both
    packages."""
    plen = max(map(len, prompts))
    batch = np.zeros((len(prompts), plen), np.int32)
    for r, p in enumerate(prompts):
        batch[r, plen - len(p):] = p
    got, _ = M.prefill(model, cfg, tokens=torch.from_numpy(batch).long(),
                       pad_to=plen + 4)
    want, _ = JM.prefill(jparams, jcfg, tokens=jnp.asarray(batch),
                         pad_to=plen + 4)
    return got.float().numpy(), np.asarray(want, np.float32)


def _recorded(engine, prompts, max_new):
    """generate, keeping the logits of every sampling call (the prefill
    of each wave, then each decode step) as f32 numpy."""
    seen = []
    sample = engine._sample

    def recording(logits, rng):
        seen.append(np.asarray(logits.float() if isinstance(
            logits, torch.Tensor) else logits, np.float32))
        return sample(logits, rng)
    engine._sample = recording
    return engine.generate(prompts, max_new), seen


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "smollm-360m",
                                  "mixtral-8x7b", "llama4-scout-17b-a16e",
                                  "granite-8b", "qwen1.5-0.5b",
                                  "qwen1.5-4b", "xlstm-350m",
                                  "qwen2-vl-72b"])
def test_generate_matches_the_reference_engine(arch, use_kernels):
    """``use_kernels`` on the port, ``use_pallas`` on the reference: the
    logits of every prefill and decode step agree, and so do the tokens."""
    cfg, model, jcfg, jparams = _pair(arch, use_kernels)
    prompts = _prompts(cfg.vocab_size)
    out, seen = _recorded(Engine(cfg, model, EngineConfig(slots=3)),
                          prompts, 6)
    ref, jseen = _recorded(JaxEngine(jcfg, jparams,
                                     JaxEngineConfig(slots=3)), prompts, 6)
    assert out == [[int(t) for t in r] for r in ref]
    assert [len(r) for r in out] == [n + 6 for n in LENGTHS]
    assert len(seen) == len(jseen) == 2 * 6         # 2 waves x 6 tokens
    for got, want in zip(seen, jseen):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bf16_compute_within_its_tolerance():
    cfg, model, jcfg, jparams = _pair("recurrentgemma-2b", True, "bfloat16")
    prompts = _prompts(cfg.vocab_size)
    got, want = _wave_logits(cfg, model, jcfg, jparams, prompts[:3])
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
    assert np.abs(want).max() > 1.0            # the tolerance is not vacuous


def test_converter_takes_the_reference_pytree():
    """Weights drawn by the reference's own ``init_params`` (jax.random)
    carry across as they are."""
    arch = "smollm-360m"
    jcfg = jax_smoke(arch).replace(compute_dtype="float32")
    cfg = get_smoke(arch).replace(compute_dtype="float32")
    jparams = init_params(jcfg, jax.random.PRNGKey(1))
    model = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                  "cpu")
    got, want = _wave_logits(cfg, model, jcfg, jparams,
                             _prompts(cfg.vocab_size, (11, 4)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_converter_rejects_a_tree_that_does_not_fit():
    cfg = get_smoke("smollm-360m")
    tree = init_numpy(cfg, 0)
    tree["final_norm"]["scale"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(tree, cfg, "cpu")
    tree = init_numpy(cfg, 0)
    del tree["groups"]["0"]["0"]["mlp"]
    with pytest.raises(KeyError, match="missing"):
        params_from_reference(tree, cfg, "cpu")


def test_eos_stops_early_and_straight_out_of_prefill():
    """The reference's prefill-EOS regression
    (``tests/test_roofline_serve.py::test_engine_eos_stops_early``): a
    first token equal to eos_id stops its row; a later one stops it
    there."""
    cfg = get_smoke("recurrentgemma-2b").replace(compute_dtype="float32")
    model = init_model(cfg, 0, "cpu")
    prompt = [[1, 2]]
    free = Engine(cfg, model, EngineConfig(slots=1)).generate(prompt, 4)[0]
    eos = free[3]                                 # second generated token
    out = Engine(cfg, model, EngineConfig(slots=1, eos_id=eos)).generate(
        prompt, 8)[0]
    assert out[-1] == eos and len(out) <= len(free) + 4
    first = free[2]
    out = Engine(cfg, model, EngineConfig(slots=1, eos_id=first)).generate(
        prompt, 8)[0]
    assert out == [1, 2, first]


def test_temperature_sampling_is_seeded():
    cfg = get_smoke("smollm-360m").replace(compute_dtype="float32")
    model = init_model(cfg, 0, "cpu")
    prompts = _prompts(cfg.vocab_size, (6, 3))
    runs = [Engine(cfg, model, EngineConfig(temperature=1.0, seed=s))
            .generate(prompts, 8) for s in (7, 7, 8)]
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_plan_waves_is_the_reference_planner():
    from repro.serve.scheduler import plan_waves as jax_plan_waves
    for n, slots in ((0, 1), (5, 2), (6, 4), (4, 4)):
        assert plan_waves(range(n), slots) == jax_plan_waves(range(n), slots)
    with pytest.raises(ValueError):
        plan_waves([1], 0)


def test_configs_are_the_reference_configs():
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    for arch in ARCH_IDS:
        for ours, theirs in ((get_config(arch), jax_config(arch)),
                             (get_smoke(arch), jax_smoke(arch))):
            a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
            # the port's kernels are on by default, the reference's off
            assert a.pop("use_kernels") is True
            assert b.pop("use_pallas") is False
            assert a == {k: b[k] for k in a}     # the port's fields agree
            # the reference's fields the port lacks keep their defaults
            defaults = {f.name: f.default
                        for f in dataclasses.fields(type(theirs))}
            assert {k: b[k] for k in b if k not in a} == \
                {k: defaults[k] for k in b if k not in a}
            assert ours.n_params() == theirs.n_params()


def test_model_defaults_to_the_card(monkeypatch):
    """Without ``device=`` the model is built on the card; on a host
    without one that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("smollm-360m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(cfg, 1, 8)
    assert init_model(cfg, 0, "cpu").device.type == "cpu"


def test_steps_are_the_model_entry_points():
    from repro_torch.models.steps import make_decode_step, make_prefill_step
    cfg = get_smoke("smollm-360m").replace(compute_dtype="float32")
    model = init_model(cfg, 0, "cpu")
    tokens = torch.tensor(_prompts(cfg.vocab_size, (7, 7)))
    logits, _ = make_prefill_step(cfg)(model, {"tokens": tokens})
    want, _ = M.prefill(model, cfg, tokens=tokens)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    caches = [M.prefill(model, cfg, tokens=tokens, pad_to=9)[1]
              for _ in range(2)]
    got, _ = make_decode_step(cfg)(model, caches[0], tokens[:, :1], 7)
    want, _ = M.decode_step(model, cfg, caches[1], tokens[:, :1], 7)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
