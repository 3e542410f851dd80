"""The golden files of the port's on-card runs of xLSTM-350M,
HuBERT-XLarge and Qwen2-VL-72B, and the phase that holds the card to
them.

``src/repro_torch/models/golden_{xlstm, hubert, qwen2_vl}.json`` hold
what the JAX package computes for ``chip_smoke.py``'s golden runs, at the
published widths and f32 compute, from numpy-seeded weights
(``chip_smoke.family_tree``) and inputs:

  * xLSTM-350M, all 24 layers: ``Engine.generate`` of one wave of four
    seeded prompts (512, 300, 37, 9 tokens), 16 greedy tokens; per prompt
    its tokens, the top-1/top-2 margin behind each and the top-8 ids and
    values of every step's logits;
  * HuBERT-XLarge, 2 of its 48 layers: ``encode`` of (2, 400) seeded
    frames; the top-8 ids and values of every frame's logits;
  * Qwen2-VL-72B, 1 of its 80 layers: a vision prefill of two images of
    1 x 16 x 16 seeded patch embeddings at their (t, h, w) positions and
    8 greedy decode steps, then ``Engine.generate`` of two token prompts,
    8 tokens; per row the same as xLSTM's.

The card's runs are held to them without JAX on that machine. These tests
keep the files complete and consistent with ``chip_smoke.py``, check each
recipe on the SMOKE configs against the JAX package, and rehearse the
card's golden phase (its planted faults included) at SMOKE size on the
CPU against golden files the JAX package writes there. Running this file
as a script regenerates the three files from the JAX package on the CPU
(Qwen2-VL's 3.38 B parameters in f32 are the peak, 14.3 GB on the host):

    PYTHONPATH=src python tests/test_torch_families_golden.py
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
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.models import model as JM
from repro.serve.llm import Engine as JaxEngine
from repro.serve.llm import EngineConfig as JaxEngineConfig
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_reference
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import model as M
from repro_torch.serve.llm import Engine, EngineConfig

ROOT = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_chip_smoke()


def jax_twin(arch, cfg, jax_of=jax_config):
    """The JAX config of ``arch`` (``jax_of``: its published or its SMOKE
    config) equal to the port's ``cfg`` field by field, on the
    reference's plain path (``use_pallas=False``)."""
    theirs = jax_of(arch).replace(n_layers=cfg.n_layers,
                                  compute_dtype=cfg.compute_dtype)
    ours, d = dataclasses.asdict(cfg), dataclasses.asdict(theirs)
    assert ours.pop("use_kernels") is True
    assert d.pop("use_pallas") is False
    assert d == ours
    return theirs


def _jax_tree(tree):
    """Move a numpy tree into JAX leaf by leaf, dropping each numpy leaf
    as it goes."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            _jax_tree(tree[k])
        else:
            tree[k] = jnp.asarray(tree.pop(k))
    return tree


def jax_vision_generate(params, jcfg, embeds, positions, steps: int):
    """``chip_smoke.vision_generate`` through the JAX package."""
    s = embeds.shape[1]
    step = jax.jit(lambda p, c, tok, pos: JM.decode_step(p, jcfg, c, tok,
                                                         pos))
    logits, cache = JM.prefill(params, jcfg, embeds=jnp.asarray(embeds),
                               positions=jnp.asarray(positions),
                               pad_to=s + steps + 1)
    calls = []
    for t in range(steps + 1):
        tok = jnp.argmax(logits, axis=-1)
        calls.append((np.asarray(logits, np.float32),
                      [int(x) for x in tok]))
        if t == steps:
            break
        logits, cache = step(params, cache, tok[:, None],
                             jnp.asarray(s + t, jnp.int32))
    return calls


def record_xlstm(cfg, jcfg, params):
    prompts = smoke.family_prompts(cfg.vocab_size,
                                   smoke.GOLDEN_XLSTM_LENGTHS, 1)
    engine = JaxEngine(jcfg, params, JaxEngineConfig(slots=smoke.XLSTM_SLOTS))
    out, calls = smoke.record_generate(engine, prompts, smoke.XLSTM_MAX_NEW)
    return {"spec": smoke.golden_xlstm_spec(),
            "prompts": smoke.steps_summary(out, calls, prompts,
                                           smoke.XLSTM_SLOTS,
                                           smoke.XLSTM_MAX_NEW)}


def record_hubert(cfg, jcfg, params):
    x = smoke.frames(smoke.GOLDEN_HUBERT_FRAMES, cfg.d_frontend, 1)
    return {"spec": smoke.golden_hubert_spec(),
            **smoke.encode_summary(JM.encode(params, jcfg, jnp.asarray(x)))}


def record_vl(cfg, jcfg, params):
    s = int(np.prod(smoke.GOLDEN_VL_GRID))
    embeds = smoke.frames((smoke.VL_IMAGES, s), cfg.d_frontend, 1)
    pos = smoke.grid_positions(smoke.VL_IMAGES, smoke.GOLDEN_VL_GRID)
    calls = jax_vision_generate(params, jcfg, embeds, pos, smoke.VL_DECODE)
    prompts = smoke.family_prompts(cfg.vocab_size, smoke.GOLDEN_VL_LENGTHS,
                                   3)
    slots = len(prompts)
    out, gcalls = smoke.record_generate(
        JaxEngine(jcfg, params, JaxEngineConfig(slots=slots)), prompts,
        smoke.VL_MAX_NEW)
    return {"spec": smoke.golden_vl_spec(),
            "vision": smoke.rows_summary(*smoke.calls_rows(calls)),
            "prompts": smoke.steps_summary(out, gcalls, prompts, slots,
                                           smoke.VL_MAX_NEW)}


def golden_configs():
    """(arch, port config, recorder, golden file) of each golden run."""
    return ((smoke.XLSTM_ARCH, smoke.family_config(smoke.XLSTM_ARCH,
                                                   golden=True),
             record_xlstm, "GOLDEN_XLSTM"),
            (smoke.HUBERT_ARCH, smoke.family_config(
                smoke.HUBERT_ARCH, smoke.GOLDEN_HUBERT_LAYERS, golden=True),
             record_hubert, "GOLDEN_HUBERT"),
            (smoke.QWEN_VL_ARCH, smoke.family_config(
                smoke.QWEN_VL_ARCH, smoke.GOLDEN_VL_LAYERS, golden=True),
             record_vl, "GOLDEN_QWEN2_VL"))


def write_golden(arch, cfg, record, path, jax_of=jax_config) -> dict:
    jcfg = jax_twin(arch, cfg, jax_of)
    golden = record(cfg, jcfg, _jax_tree(smoke.family_tree(cfg)))
    Path(path).write_text(json.dumps(golden) + "\n")
    return golden


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------

def _check_rows(rows, n_steps):
    for row in rows:
        assert len(row["tokens"]) == len(row["margins"]) == n_steps
        assert len(row["top_ids"]) == len(row["top_vals"]) == n_steps
        for ids, vals, tok in zip(row["top_ids"], row["top_vals"],
                                  row["tokens"]):
            assert len(ids) == len(vals) == smoke.LM_TOPK
            assert vals == sorted(vals, reverse=True)
            assert tok == ids[0]                     # greedy
        assert all(m >= 0 for m in row["margins"])


def test_golden_files_are_complete():
    for arch, cfg, _, _ in golden_configs():
        jax_twin(arch, cfg)
    xl = json.loads(smoke.GOLDEN_XLSTM.read_text())
    assert xl["spec"] == smoke.golden_xlstm_spec()
    assert len(xl["prompts"]) == len(smoke.GOLDEN_XLSTM_LENGTHS)
    _check_rows(xl["prompts"], smoke.XLSTM_MAX_NEW)
    hu = json.loads(smoke.GOLDEN_HUBERT.read_text())
    assert hu["spec"] == smoke.golden_hubert_spec()
    assert np.asarray(hu["top_ids"]).shape == (*smoke.GOLDEN_HUBERT_FRAMES,
                                               smoke.LM_TOPK)
    vals = np.asarray(hu["top_vals"])
    assert (np.diff(vals, axis=-1) <= 0).all()
    vl = json.loads(smoke.GOLDEN_QWEN2_VL.read_text())
    assert vl["spec"] == smoke.golden_vl_spec()
    assert len(vl["vision"]) == smoke.VL_IMAGES
    _check_rows(vl["vision"], smoke.VL_DECODE + 1)
    assert len(vl["prompts"]) == len(smoke.GOLDEN_VL_LENGTHS)
    _check_rows(vl["prompts"], smoke.VL_MAX_NEW)


def test_inputs_are_seeded_and_sized():
    a = smoke.frames((2, 5), 7, 1)
    assert a.shape == (2, 5, 7) and a.dtype == np.float32
    assert np.array_equal(a, smoke.frames((2, 5), 7, 1))
    pos = smoke.grid_positions(2, (1, 3, 4))
    assert pos.shape == (3, 2, 12)
    assert pos[:, 0, 5].tolist() == [0, 1, 1]            # row 1, column 1
    assert (pos[0] == 0).all() and (pos[:, 0] == pos[:, 1]).all()
    for lengths in (smoke.GOLDEN_XLSTM_LENGTHS, smoke.XLSTM_LENGTHS):
        p = smoke.family_prompts(50_304, lengths, 1)
        assert [len(x) for x in p] == list(lengths)
    # the consistency split runs no padded sLSTM step; the golden wave
    # does
    split = smoke.XLSTM_SPLIT
    assert split % int(split ** 0.5) == 0
    wave = max(smoke.GOLDEN_XLSTM_LENGTHS)
    assert wave % int(wave ** 0.5) != 0
    assert split < wave + smoke.XLSTM_MAX_NEW
    # the flash shapes are the main paths'
    hub = smoke.family_config(smoke.HUBERT_ARCH)
    n, s = smoke.HUBERT_FRAMES
    assert smoke.FLASH_HUBERT[:7] == (n * hub.n_heads, n * hub.n_kv_heads,
                                      s, s, hub.hd, False, 0)
    vl = smoke.family_config(smoke.QWEN_VL_ARCH)
    s = int(np.prod(smoke.VL_GRID))
    assert smoke.FLASH_QWEN_VL[:7] == (
        smoke.VL_IMAGES * vl.n_heads, smoke.VL_IMAGES * vl.n_kv_heads, s, s,
        vl.hd, True, 0)


def test_family_tree_draws_layernorm_leaves():
    cfg = smoke.family_config(smoke.HUBERT_ARCH).replace(
        n_layers=1, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab_size=16, d_frontend=8)
    tree = smoke.family_tree(cfg)
    mixer = tree["groups"]["0"]["0"]["mixer"]
    assert abs(float(mixer["wo"]["b"].mean()) - 0.1) < 0.1
    assert float(np.abs(mixer["norm"]["scale"] - 1).max()) > 0.1
    again = smoke.family_tree(cfg)
    assert np.array_equal(again["final_norm"]["bias"],
                          tree["final_norm"]["bias"])
    xl = smoke.family_config(smoke.XLSTM_ARCH).replace(n_layers=1)
    assert not smoke.family_tree(xl)["groups"]["0"]["0"]["mixer"][
        "conv"]["b"].any()                       # RMSNorm models: as init


# ---------------------------------------------------------------------------
# the recipes on SMOKE configs, both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_goldens(tmp_path_factory):
    """The three golden files at SMOKE size (short inputs), written by the
    JAX package; chip_smoke's constants cut to match while the fixture
    is open."""
    mp = pytest.MonkeyPatch()
    mp.setattr(smoke, "get_config", get_smoke)
    for name, value in (("GOLDEN_XLSTM_LENGTHS", (24, 17, 9, 5)),
                        ("XLSTM_SPLIT", 30),
                        ("GOLDEN_HUBERT_FRAMES", (2, 40)),
                        ("GOLDEN_VL_GRID", (1, 4, 4)),
                        ("GOLDEN_VL_LENGTHS", (12, 7))):
        mp.setattr(smoke, name, value)
    d = tmp_path_factory.mktemp("golden")
    out = {}
    for arch, cfg, record, name in golden_configs():
        path = d / f"{name}.json"
        mp.setattr(smoke, name, path)
        out[name] = write_golden(arch, cfg, record, path, jax_smoke)
    yield out
    mp.undo()


def test_recipes_agree_across_packages_on_smoke(smoke_goldens):
    """The port's run of each recipe at SMOKE size on the CPU against the
    JAX package's file: top-8 logits within 1e-4, tokens equal."""
    dev = torch.device("cpu")
    for _, cfg, _, name in golden_configs():
        golden = smoke_goldens[name]
        model = params_from_reference(smoke.family_tree(cfg), cfg, dev)
        if name == "GOLDEN_HUBERT":
            x = torch.from_numpy(smoke.frames(smoke.GOLDEN_HUBERT_FRAMES,
                                              cfg.d_frontend, 1))
            assert smoke.encode_err(M.encode(model, cfg, x), golden) < 1e-4
            continue
        if name == "GOLDEN_XLSTM":
            prompts = smoke.family_prompts(cfg.vocab_size,
                                           smoke.GOLDEN_XLSTM_LENGTHS, 1)
            out, calls = smoke.record_generate(
                Engine(cfg, model, EngineConfig(slots=smoke.XLSTM_SLOTS)),
                prompts, smoke.XLSTM_MAX_NEW)
            steps = smoke.per_prompt(calls, len(prompts), smoke.XLSTM_SLOTS,
                                     smoke.XLSTM_MAX_NEW)
            rows = smoke.steps_summary(out, calls, prompts,
                                       smoke.XLSTM_SLOTS, smoke.XLSTM_MAX_NEW)
            want, n = golden["prompts"], smoke.XLSTM_MAX_NEW
        else:
            emb, pos = smoke._vision_inputs(cfg, smoke.GOLDEN_VL_GRID, 1, dev)
            calls = smoke.vision_generate(model, cfg, emb, pos,
                                          smoke.VL_DECODE)
            steps, toks = smoke.calls_rows(calls)
            rows = smoke.rows_summary(steps, toks)
            want, n = golden["vision"], smoke.VL_DECODE + 1
        err, matched, _ = smoke.golden_steps_err(steps, rows, want, n, name)
        assert err < 1e-4 and min(matched) > 0, (name, err, matched)


def test_first_layers_are_the_shallower_seeded_model():
    """A stacked leaf's first layers are drawn as a shallower stack's,
    across the seeded streams' boundaries too, so ``first_layers`` of
    the main path's model is the golden run's model."""
    from repro_torch.models.schema import ParamSpec, STREAM, _leaf
    per_layer = (1200, 4000)
    assert per_layer[0] * per_layer[1] > STREAM
    leaves = []
    for reps in (3, 1):
        jobs = []
        leaves.append(_leaf(ParamSpec((reps, *per_layer), "normal", 0.5),
                            7, "groups/0/0/mixer/wq/w", jobs))
        for job in jobs:
            job()
    np.testing.assert_array_equal(leaves[0][:1], leaves[1])
    cfg = get_smoke(smoke.QWEN_VL_ARCH).replace(compute_dtype="float32")
    deep = smoke.init_model(cfg.replace(n_layers=3), 0, "cpu")
    shallow = smoke.init_model(cfg.replace(n_layers=1), 0, "cpu")
    view = smoke.first_layers(deep, 1)
    assert len(view.layers) == 1 and len(deep.layers) == 3
    x = torch.from_numpy(smoke.frames((2, 12), cfg.d_frontend, 5))
    one = cfg.replace(n_layers=1)
    got, _ = M.prefill(view, one, embeds=x)
    want, _ = M.prefill(shallow, one, embeds=x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _cpu_card(monkeypatch):
    """The card's phase on the CPU: no device synchronisation, and
    flash_attention's calls counted by route as its launches would be."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    orig = fa.flash_attention

    def counted(q, k, v, **kw):
        fa.LAUNCHES += 1
        fa.ROUTE_LAUNCHES[fa.route(q.dtype, q.shape[-1])] += 1
        return orig(q, k, v, **kw)
    monkeypatch.setattr(fa, "flash_attention", counted)


def test_golden_phase_and_its_faults_on_smoke(smoke_goldens, monkeypatch,
                                              capsys):
    """``xlstm_golden``, ``hubert_golden`` and ``vl_golden`` as the card
    runs them, at SMOKE size on the CPU against the JAX package's files:
    every check passes, the sound runs sit at f32 rounding and each
    planted fault lands far past GOLDEN_TOL."""
    _cpu_card(monkeypatch)
    dev = torch.device("cpu")
    xl, model = smoke.xlstm_golden(dev)
    assert model.layers[0].kind == "mlstm"
    hu = smoke.hubert_golden(dev)
    deep, _ = smoke._init_timed(smoke.family_config(
        smoke.QWEN_VL_ARCH, smoke.VL_LAYERS), dev)
    vl = smoke.vl_golden(dev, deep)
    assert xl["top_max_abs_err"] < 1e-4 and hu["top_max_abs_err"] < 1e-4
    assert max(vl["vision"]["top_max_abs_err"],
               vl["generate"]["top_max_abs_err"]) < 1e-4
    assert xl["consistency"]["decode_vs_prefill"] < 1e-4
    assert xl["consistency"]["chunked_vs_recurrent"] < 1e-5
    # the chunk-end C 1e-3 high: inside the logits limit, past the state's
    (state_fault,) = xl["consistency"]["planted_fault"].values()
    assert smoke.XLSTM_STATE_TOL < state_fault < smoke.XLSTM_TOL
    for faults in (xl["planted_faults"], hu["planted_faults"],
                   vl["planted_faults_on_the_vision_prefill"]):
        assert len(faults) == 3
        assert min(faults.values()) > 10 * smoke.GOLDEN_TOL, faults
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [next(iter(x)) for x in lines] == ["xlstm_golden",
                                              "hubert_golden",
                                              "qwen2_vl_golden"]


def main() -> None:
    for arch, cfg, record, name in golden_configs():
        path = getattr(smoke, name)
        golden = write_golden(arch, cfg, record, path)
        print(path.name, json.dumps(golden["spec"]), file=sys.stderr,
              flush=True)


if __name__ == "__main__":
    main()
