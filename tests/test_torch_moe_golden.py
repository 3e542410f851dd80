"""The golden file of the port's on-card MoE run, and the MoE comparison's
machinery.

``src/repro_torch/models/golden_moe.json`` holds what the JAX package's
``Engine.generate`` gives for ``chip_smoke.py``'s MoE golden run:
Mixtral-8x7B at full width, 1 of its 32 layers, f32 compute,
numpy-seeded weights (``repro_torch.models.schema.init_numpy``), six
seeded prompts (the longest past the 4,096-token window) in two waves of
4 slots, 16 greedy tokens each. Per prompt it keeps the generated tokens,
the top-1/top-2 margin of the logits behind each, and the top-8 ids and
values of every step's logits; per sampling call, the smallest gap
between the k-th and (k+1)-th router probability over the forward's
tokens, so that an expert flip can be told from a wrong kernel. The
card's run is held to it without JAX on that machine.

These tests keep the file complete and consistent with ``chip_smoke.py``,
check the recording on a SMOKE model against the JAX package, and run
the card's kernel-against-plain comparison (``kernel_vs_plain``, with its
planted faults) on the CPU at SMOKE size. Running this file as a script
regenerates the file from the JAX package on the CPU (a peak resident
memory of 17.6 GB and 131 s on 8 cores):

    PYTHONPATH=src python tests/test_torch_moe_golden.py
"""
import contextlib
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
from repro.models import layers as JL
from repro.models import model as JM
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
    """The JAX twin of ``chip_smoke.moe_config(golden=True)``, on the
    reference's plain path (``use_pallas=False``)."""
    ours = dataclasses.asdict(smoke.moe_config(golden=True))
    ours.pop("use_kernels")
    cfg = jax_config(smoke.MOE_ARCH).replace(
        n_layers=smoke.GOLDEN_MOE_LAYERS, compute_dtype="float32")
    theirs = dataclasses.asdict(cfg)
    assert theirs.pop("use_pallas") is False
    assert ours == {k: theirs[k] for k in ours}
    return cfg


@contextlib.contextmanager
def jax_router_gaps():
    """While open, the JAX model's MoE layers also report their smallest
    router gap (``jax.debug.callback``, which runs inside the jitted
    decode step too). Yields ``take``: the smallest gap reported since
    the last take, a ``per_call`` for ``record_generate``."""
    gaps = []
    orig = JM.apply_moe

    def recording(p, x, cfg):
        hx = JL.apply_norm(p["norm"], x, cfg)
        logits = jnp.einsum("bsd,de->bse", hx.astype(jnp.float32),
                            p["router"]["w"].astype(jnp.float32))
        k = cfg.topk
        top = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k + 1)[0]
        jax.debug.callback(lambda g: gaps.append(float(g)),
                           jnp.min(top[..., k - 1] - top[..., k]))
        return orig(p, x, cfg)

    def take():
        jax.effects_barrier()
        out = min(gaps)
        gaps.clear()
        return out
    JM.apply_moe = recording
    try:
        yield take
    finally:
        JM.apply_moe = orig


def test_golden_file_is_complete_and_matches_the_smoke_run():
    golden = json.loads(smoke.GOLDEN_MOE.read_text())
    assert golden["spec"] == smoke.golden_moe_spec()
    jax_golden_config()
    assert len(golden["prompts"]) == len(smoke.GOLDEN_MOE_LENGTHS)
    for row in golden["prompts"]:
        n = smoke.MOE_MAX_NEW
        assert len(row["tokens"]) == len(row["margins"]) == n
        assert len(row["top_ids"]) == len(row["top_vals"]) == n
        for ids, vals, tok in zip(row["top_ids"], row["top_vals"],
                                  row["tokens"]):
            assert len(ids) == len(vals) == smoke.LM_TOPK
            assert vals == sorted(vals, reverse=True)
            assert tok == ids[0]                     # greedy
        assert all(m >= 0 for m in row["margins"])
    assert len(golden["router_gaps"]) == 2 * smoke.MOE_MAX_NEW
    assert all(g >= 0 for g in golden["router_gaps"])


def test_prompts_are_seeded_and_sized():
    for lengths in (smoke.GOLDEN_MOE_LENGTHS, smoke.MOE_LENGTHS,
                    smoke.SCOUT_LENGTHS, smoke.QWEN_LENGTHS):
        a = smoke.moe_prompts(32_000, lengths)
        assert a == smoke.moe_prompts(32_000, lengths)
        assert [len(p) for p in a] == list(lengths)
        assert all(0 <= t < 32_000 for p in a for t in p)
    # the golden run's first wave rolls the 4,096-token window cache; the
    # main path's first wave is flash_attention's FLASH_MOE shape
    window = smoke.moe_config().window
    assert max(smoke.GOLDEN_MOE_LENGTHS[:smoke.MOE_SLOTS]) > window
    assert max(smoke.GOLDEN_MOE_LENGTHS[smoke.MOE_SLOTS:]) < window
    cfg = smoke.moe_config()
    bh, bhkv, sq, _, hd, causal, win, _ = smoke.FLASH_MOE
    assert (bh, bhkv, sq, hd, win) == (
        smoke.MOE_SLOTS * cfg.n_heads, smoke.MOE_SLOTS * cfg.n_kv_heads,
        max(smoke.MOE_LENGTHS), cfg.hd, cfg.window) and causal


def _smoke_pair(arch, seed):
    cfg = get_smoke(arch).replace(compute_dtype="float32")
    jcfg = jax_smoke(arch).replace(compute_dtype="float32")
    tree = init_numpy(cfg, seed)
    return cfg, params_from_reference(tree, cfg, "cpu"), jcfg, \
        jax.tree.map(jnp.asarray, tree)


def test_recording_on_a_smoke_model_agrees_across_packages():
    """The golden file's recipe at SMOKE size: recording changes nothing
    the engine returns, and the port's summary (its router gaps
    included) agrees with the JAX package's."""
    cfg, model, jcfg, jparams = _smoke_pair(smoke.MOE_ARCH, 0)
    prompts = smoke.moe_prompts(cfg.vocab_size, (30, 5, 17, 9, 12, 3))
    ecfg = dict(slots=smoke.MOE_SLOTS)
    port = Engine(cfg, model, EngineConfig(**ecfg))
    with smoke.RoutingLog() as log:
        out, calls = smoke.record_generate(port, prompts, smoke.MOE_MAX_NEW,
                                           per_call=smoke._min_gap(log))
    assert out == port.generate(prompts, smoke.MOE_MAX_NEW)
    ref = JaxEngine(jcfg, jparams, JaxEngineConfig(**ecfg))
    with jax_router_gaps() as take:
        jout, jcalls = smoke.record_generate(ref, prompts, smoke.MOE_MAX_NEW,
                                             per_call=take)
    mine = smoke.moe_summarize(out, calls, prompts)
    theirs = smoke.moe_summarize(jout, jcalls, prompts)
    np.testing.assert_allclose(mine["router_gaps"], theirs["router_gaps"],
                               atol=1e-6)
    for i, (a, b) in enumerate(zip(mine["prompts"], theirs["prompts"])):
        n = smoke._matched_steps(a["tokens"], b["tokens"], b["margins"],
                                 1e-4, f"prompt {i}")
        assert n > 0
        for t in range(min(n + 1, smoke.MOE_MAX_NEW)):
            np.testing.assert_allclose(a["top_vals"][t], b["top_vals"][t],
                                       atol=1e-4)


def test_kernel_vs_plain_comparison_on_a_smoke_model():
    """The card's comparison at SMOKE size on the CPU, where the kernel
    path's wrappers run their plain versions: the clean comparison is at
    f32 rounding with no expert changed, and every fault that the card
    run must catch moves the error or the routing far past it."""
    cfg, model, _, _ = _smoke_pair(smoke.MOE_ARCH, 1)
    prompts = smoke.moe_prompts(cfg.vocab_size, (40, 23, 30, 9, 33, 6))
    before = smoke.launch_counts()
    res = smoke.kernel_vs_plain(cfg, model, prompts, smoke.MOE_SLOTS,
                                smoke.MOE_MAX_NEW, smoke.MOE_TOL,
                                smoke.MOE_FAULTS)
    assert smoke.launch_counts() == before
    clean = res["forced_vs_plain"]
    assert clean["max"] < 1e-4 and clean["flipped_call_rows"] == 0
    assert clean["tokens_with_other_experts"] == [0] * len(
        clean["tokens_with_other_experts"])
    assert clean["call_rows"] == 6 * smoke.MOE_MAX_NEW
    for name, f in res["planted_faults"].items():
        if f["must_fail"]:
            assert f["max"] > 100 * clean["max"] or \
                f["max_flip_gap"] > smoke.MOE_GAP_TOL, name
    # a window halved at SMOKE size moves routing as well as logits
    assert sum(res["planted_faults"]["flash_attention window halved"][
        "tokens_with_other_experts"]) > 0


def _to_jax(tree):
    """Move a numpy tree into JAX leaf by leaf, dropping each numpy leaf
    as it goes (the golden model is ~6.9 GB)."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            _to_jax(tree[k])
        else:
            tree[k] = jnp.asarray(tree.pop(k))
    return tree


def main() -> None:
    jcfg = jax_golden_config()
    tree = _to_jax(init_numpy(smoke.moe_config(golden=True), smoke.MOE_SEED))
    prompts = smoke.moe_prompts(jcfg.vocab_size, smoke.GOLDEN_MOE_LENGTHS)
    engine = JaxEngine(jcfg, tree, JaxEngineConfig(slots=smoke.MOE_SLOTS))
    with jax_router_gaps() as take:
        out, calls = smoke.record_generate(engine, prompts,
                                           smoke.MOE_MAX_NEW, per_call=take)
    golden = {"spec": smoke.golden_moe_spec(),
              **smoke.moe_summarize(out, calls, prompts)}
    for i, row in enumerate(golden["prompts"]):
        print(i, row["tokens"], f"min margin {min(row['margins']):.4g}",
              file=sys.stderr, flush=True)
    print("min router gap", min(golden["router_gaps"]), file=sys.stderr)
    smoke.GOLDEN_MOE.write_text(json.dumps(golden, indent=1) + "\n")


if __name__ == "__main__":
    main()
