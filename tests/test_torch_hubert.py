"""HuBERT-XLarge in the port against the JAX package's, on the CPU, at f32
compute: LayerNorm with its bias, the GELU MLP with its biases (the tanh
approximation, ``jax.nn.gelu``'s default), the bidirectional attention
block with ``wo``'s bias, and ``encode`` as a whole on the JAX side's
plain path and through its Pallas kernel in interpret mode, with the
port's ``use_kernels`` both ways. Weights from ``schema.init_numpy`` with
every bias and LayerNorm scale then drawn from numpy too (they start at 0
and 1, where a missing bias would not show); inputs from numpy, both
seeded. The layers within 1e-5 (f32 sums in another order), ``encode``'s
logits within 1e-4. Loss and gradients are in
``tests/test_torch_train.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import ModelConfig as JaxConfig
from repro.models.steps import make_encode_step as jax_encode_step
from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import load_tree, params_from_reference
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.schema import init_numpy, schema
from repro_torch.models.steps import make_encode_step

ARCH = "hubert-xlarge"
CFG = get_smoke(ARCH).replace(compute_dtype="float32", use_kernels=False)
ATOL = 1e-5


def jax_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["use_pallas"] = fields.pop("use_kernels")
    return JaxConfig(**fields)


def with_drawn_biases(tree, seed):
    """``tree`` with every bias and LayerNorm scale drawn from numpy."""
    g = np.random.default_rng(seed)

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("b", "bias"):
                t[k] = (0.1 + 0.2 * g.standard_normal(v.shape)).astype(
                    np.float32)
            elif k == "scale":
                t[k] = (1 + 0.2 * g.standard_normal(v.shape)).astype(
                    np.float32)
    walk(tree)
    return tree


TREE = with_drawn_biases(init_numpy(CFG, seed=0), 1)
LAYER = jax.tree.map(lambda x: np.asarray(x)[0], TREE["groups"]["0"]["0"])


def rand(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_layernorm_with_bias():
    p = LAYER["mixer"]["norm"]
    assert set(p) == {"scale", "bias"}
    m = L.Norm(CFG.d_model, CFG, "cpu")
    load_tree(m, p)
    x, jxx = rand((2, 9, CFG.d_model), 2)
    x, jxx = x + 3.0, jxx + 3.0                 # the mean is subtracted
    close(L.apply_norm(m, x, CFG), JL.apply_norm(
        jax.tree.map(jnp.asarray, p), jxx, jax_cfg(CFG)))


def test_gelu_mlp_with_biases():
    """The tanh GELU: the erf form is ~1e-3 away and would fail."""
    p = LAYER["mlp"]
    assert set(p["wi"]) == set(p["wo"]) == {"w", "b"}
    m = L.MLP(CFG, "cpu")
    load_tree(m, p)
    x, jxx = rand((2, 9, CFG.d_model), 3)
    got = L.apply_mlp(m, x, CFG)
    close(got, JL.apply_mlp(jax.tree.map(jnp.asarray, p), jxx, jax_cfg(CFG)))
    erf = L.linear(m.wo, torch.nn.functional.gelu(L.linear(
        m.wi, L.apply_norm(m.norm, x, CFG), CFG)), CFG)
    assert float((erf - got).abs().max()) > 10 * ATOL


@pytest.mark.parametrize("use_kernels", [False, True])
def test_bidirectional_attention_block(use_kernels):
    """causal=False with ``wo``'s bias, the plain path and the kernel's
    wrapper (its plain version on CPU tensors) against the reference's
    blocked attention and its Pallas kernel in interpret mode."""
    cfg = CFG.replace(use_kernels=use_kernels)
    p = LAYER["mixer"]
    assert "b" in p["wo"]
    m = A.AttnMixer(cfg, "cpu")
    load_tree(m, p)
    x, jxx = rand((2, 23, CFG.d_model), 4)
    out, _ = A.attn_block(m, x, cfg, "attn")
    jout, _ = JA.attn_block(jax.tree.map(jnp.asarray, p), jxx, jax_cfg(cfg),
                            "attn")
    close(out, jout)
    causal, _ = A.attn_block(m, x, cfg.replace(causal=True), "attn")
    assert float((causal - out).abs().max()) > 1e-2


@pytest.fixture(scope="module")
def model():
    return params_from_reference(TREE, CFG, "cpu")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_encode_matches_the_reference(model, use_kernels):
    """``encode`` on (2, 37) frames: the port with ``use_kernels`` on and
    off against the reference with ``use_pallas`` the same way, logits
    of every frame within 1e-4."""
    cfg = CFG.replace(use_kernels=use_kernels)
    e, je = rand((2, 37, CFG.d_frontend), 5)
    got = M.encode(model, cfg, e)
    want = JM.encode(jax.tree.map(jnp.asarray, TREE), jax_cfg(cfg), je)
    assert got.shape == (2, 37, CFG.vocab_size)
    close(got, want, 1e-4)


def test_encode_step_is_encode(model):
    e, je = rand((2, 11, CFG.d_frontend), 6)
    got = make_encode_step(CFG)(model, {"embeds": e})
    close(got, M.encode(model, CFG, e), 0)
    close(got, jax_encode_step(jax_cfg(CFG))(
        jax.tree.map(jnp.asarray, TREE), {"embeds": je}), 1e-4)


def test_encode_reaches_the_kernel_only_without_a_gradient(monkeypatch):
    """No gradient wanted: the inference route, every layer through
    ``flash_attention`` under ``use_kernels``; a gradient wanted: the
    train-mode stack, which refuses the kernels, and runs the plain
    path without them, equal to the inference route."""
    calls = []
    orig = kops.flash_attention

    def counting(*args, **kw):
        calls.append(kw["causal"])
        return orig(*args, **kw)
    monkeypatch.setattr(kops, "flash_attention", counting)
    cfg = CFG.replace(use_kernels=True)
    model = params_from_reference(TREE, cfg, "cpu")
    e, _ = rand((1, 9, CFG.d_frontend), 7)
    served = M.encode(model, cfg, e)
    assert calls == [False] * CFG.n_layers
    model.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.encode(model, cfg, e)
    plain = CFG.replace(use_kernels=False)
    trained = M.encode(model, plain, e)
    assert trained.requires_grad and len(calls) == CFG.n_layers
    close(trained, served.numpy())


def test_no_token_embedding():
    """Audio frames in place of tokens: no ``embed`` in the schema or the
    model, and token ids are refused."""
    assert "embed" not in schema(CFG) and "frontend_proj" in schema(CFG)
    model = M.LM(CFG, "cpu")
    assert model.embed is None and model.device.type == "cpu"
    with pytest.raises(ValueError, match="no token embedding"):
        M.forward(model, CFG, tokens=torch.zeros((1, 4), dtype=torch.long))


def test_config_equals_the_reference():
    for ours, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_smoke(ARCH), jax_smoke(ARCH))):
        a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        assert a.pop("use_kernels") is True and b.pop("use_pallas") is False
        assert a == b
        assert ours.n_params() == theirs.n_params()
    assert get_config(ARCH).n_params() == 945_635_840          # 945.6 M
