"""Qwen2-VL-72B in the port against the JAX package's, on the CPU, at f32
compute: M-RoPE with distinct (t, h, w) streams and with equal ones (the
replay of ``tests/test_models.py:181``: then it is RoPE), the attention
block on (3, B, S) positions, a vision prefill of patch embeddings on a
(t, h, w) grid followed by decode steps (``use_kernels`` and
``use_pallas`` both ways), the prefill step's ``embeds``/``positions``,
and the loss, gradients and a 2-microbatch train step on patch
embeddings with their positions. Weights from ``schema.init_numpy`` and
inputs from numpy, both seeded; layers within 1e-5, a whole model's
logits within 1e-4, losses 1e-6 relative and gradients within 1e-5 of
each tensor's largest |x| (``tests/test_torch_train.py``'s limits).
``Engine.generate`` on token prompts is in ``tests/test_torch_llm.py``."""
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
from repro.models.steps import make_train_step as jax_train_step
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import load_tree, params_from_reference
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.schema import init_numpy
from repro_torch.models.steps import make_prefill_step, make_train_step
from repro_torch.optim import adamw

ARCH = "qwen2-vl-72b"
CFG = get_smoke(ARCH).replace(compute_dtype="float32", use_kernels=False)
TREE = init_numpy(CFG, seed=0)
ATOL = 1e-5


def jax_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["use_pallas"] = fields.pop("use_kernels")
    return JaxConfig(**fields)


def rand(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def grid(b, t, h, w):
    """(3, b, t·h·w) positions of a t x h x w patch grid, row-major:
    patch (i, j, k) sits at (t, h, w) = (i, j, k)."""
    ii, jj, kk = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    pos = np.stack([ii.ravel(), jj.ravel(), kk.ravel()])
    return np.array(np.broadcast_to(pos[:, None], (3, b, pos.shape[1])))


def test_apply_mrope_distinct_streams():
    x, jxx = rand((2, 12, 3, 16), 1)
    pos = np.random.default_rng(2).integers(0, 500, (3, 2, 12))
    got = L.apply_mrope(x, torch.from_numpy(pos), 1e4, (2, 3, 3))
    close(got, JL.apply_mrope(jxx, jnp.asarray(pos), 1e4, (2, 3, 3)))
    # each section follows its own stream: moving the w stream leaves the
    # t and h sections (the first 2 + 3 frequencies of each half) as they
    # were
    moved = pos.copy()
    moved[2] += 7
    other = L.apply_mrope(x, torch.from_numpy(moved), 1e4, (2, 3, 3))
    for half in (0, 8):
        close(other[..., half:half + 5], got[..., half:half + 5].numpy(), 0)
        assert float((other[..., half + 5:half + 8]
                      - got[..., half + 5:half + 8]).abs().max()) > 1e-2


def test_mrope_equals_rope_for_equal_streams():
    """The replay of tests/test_models.py:181, and the full-width
    sections (16, 24, 24) at hd 128."""
    for hd, sections in ((16, (2, 3, 3)), (128, (16, 24, 24))):
        x, jxx = rand((1, 6, 2, hd), 3)
        pos = np.arange(6)[None]
        want = JL.apply_rope(jxx, jnp.asarray(pos), 1e6)
        got = L.apply_mrope(x, torch.from_numpy(pos).expand(3, 1, 6), 1e6,
                            sections)
        close(got, want)
        close(L.apply_rope(x, torch.from_numpy(pos), 1e6), want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_attn_block_on_three_streams(use_kernels):
    cfg = CFG.replace(use_kernels=use_kernels)
    p = jax.tree.map(lambda x: np.asarray(x)[0],
                     TREE["groups"]["0"]["0"]["mixer"])
    m = A.AttnMixer(cfg, "cpu")
    load_tree(m, p)
    x, jxx = rand((2, 16, CFG.d_model), 4)
    pos = grid(2, 1, 4, 4)
    out, _ = A.attn_block(m, x, cfg, "attn", positions=torch.from_numpy(pos))
    jout, _ = JA.attn_block(jax.tree.map(jnp.asarray, p), jxx, jax_cfg(cfg),
                            "attn", positions=jnp.asarray(pos))
    close(out, jout)


@pytest.fixture(scope="module")
def model():
    return params_from_reference(TREE, CFG, "cpu")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_vision_prefill_then_decode(model, use_kernels):
    """Patch embeddings of a 2 x 3 x 4 grid (24 patches), then 4 greedy
    decode steps on token ids at positions 24.. (every stream the same,
    as the reference decodes): every step's logits within 1e-4, the
    tokens equal."""
    cfg = CFG.replace(use_kernels=use_kernels)
    jcfg, jparams = jax_cfg(cfg), jax.tree.map(jnp.asarray, TREE)
    e, je = rand((2, 24, CFG.d_frontend), 5)
    pos = grid(2, 2, 3, 4)
    logits, cache = M.prefill(model, cfg, embeds=e,
                              positions=torch.from_numpy(pos), pad_to=29)
    jlogits, jcache = JM.prefill(jparams, jcfg, embeds=je,
                                 positions=jnp.asarray(pos), pad_to=29)
    close(logits, jlogits, 1e-4)
    for t in range(24, 28):
        tok = np.asarray(jlogits).argmax(-1)[:, None]
        assert torch.equal(logits.argmax(-1), torch.from_numpy(tok[:, 0]))
        logits, cache = M.decode_step(model, cfg, cache,
                                      torch.from_numpy(tok), t)
        jlogits, jcache = JM.decode_step(jparams, jcfg, jcache,
                                         jnp.asarray(tok), t)
        close(logits, jlogits, 1e-4)


def test_grid_positions_are_not_plain_rope(model):
    """The vision prefill on grid positions differs from the same patches
    on 0..S-1 in every stream: the streams reach the model."""
    e, _ = rand((1, 24, CFG.d_frontend), 6)
    on_grid, _ = M.prefill(model, CFG, embeds=e,
                           positions=torch.from_numpy(grid(1, 2, 3, 4)))
    flat, _ = M.prefill(model, CFG, embeds=e)
    assert float((on_grid - flat).abs().max()) > 1e-3


def test_prefill_step_passes_embeds_and_positions(model):
    e, _ = rand((2, 12, CFG.d_frontend), 7)
    pos = torch.from_numpy(grid(2, 1, 3, 4))
    got, _ = make_prefill_step(CFG)(model, {"embeds": e, "positions": pos})
    want, _ = M.prefill(model, CFG, embeds=e, positions=pos)
    close(got, want.numpy(), 0)


def _vision_batch(b, seed):
    """Patch embeddings of a 1 x 4 x 6 grid, their positions and labels."""
    g = np.random.default_rng(seed)
    return {"embeds": g.standard_normal((b, 24, CFG.d_frontend)).astype(
                np.float32),
            "positions": grid(b, 1, 4, 6),
            "labels": g.integers(0, CFG.vocab_size, (b, 24)).astype(
                np.int32)}


def test_loss_and_gradients_on_patches():
    cfg = CFG.replace(attn_q_chunk=8, attn_kv_chunk=16)
    batch = _vision_batch(2, 8)
    jloss, jgrads = jax.value_and_grad(lambda p: JM.loss_fn(
        p, jax_cfg(cfg), jax.tree.map(jnp.asarray, batch)))(
        jax.tree.map(jnp.asarray, TREE))
    model = params_from_reference(TREE, cfg, "cpu")
    model.requires_grad_(True)
    loss = M.loss_fn(model, cfg, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    loss.backward()
    want = dict(params_from_reference(jax.tree.map(np.asarray, jgrads), cfg,
                                      "cpu").named_parameters())
    assert model.embed.w.grad is None          # no token reached it
    assert float(want["embed.w"].abs().max()) == 0.0
    for name, p in model.named_parameters():
        if p.grad is not None:
            close(p.grad, want[name].detach().numpy(),
                  1e-5 * float(want[name].abs().max()))


def test_train_step_slices_the_position_streams():
    """Two microbatches of (3, B, S) positions are cut along B: a step's
    loss, grad_norm and lr equal the reference's within 1e-6."""
    cfg = CFG.replace(attn_q_chunk=8, attn_kv_chunk=16, remat="dots")
    hp = dict(lr=1e-3, warmup_steps=2, total_steps=6)
    batch = _vision_batch(4, 9)
    step = jax.jit(jax_train_step(jax_cfg(cfg), jadamw.AdamWConfig(**hp),
                                  microbatches=2))
    params = jax.tree.map(jnp.asarray, TREE)
    _, _, jm = step(params, jadamw.init(params),
                    jax.tree.map(jnp.asarray, batch))
    model = params_from_reference(TREE, cfg, "cpu")
    model.requires_grad_(True)
    got = make_train_step(cfg, adamw.AdamWConfig(**hp), microbatches=2)(
        model, adamw.init(dict(model.named_parameters())),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)


def test_config_equals_the_reference():
    for ours, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_smoke(ARCH), jax_smoke(ARCH))):
        a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        assert a.pop("use_kernels") is True and b.pop("use_pallas") is False
        assert a == b
        assert ours.n_params() == theirs.n_params()
    assert get_config(ARCH).n_params() == 72_715_018_240       # 72.7 B
