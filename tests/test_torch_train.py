"""The port's training path against the JAX package's, on the CPU, at f32
compute: the cross entropy and the chunked LM loss, blocked and windowed
attention (also against the port's full-matrix ``plain_attention``), the
loss (with the MoE layers' aux loss) and every gradient of the SMOKE
configs of all ten architectures (HuBERT on frame embeddings and
labels), and ``make_train_step`` over 3 steps
with 1 and 2 microbatches; the four remat modes against each other;
kernels in train mode refused.

Weights come from ``schema.init_numpy`` and inputs from numpy, both
seeded; gradients of the JAX package map onto the port's parameters
through ``convert.params_from_reference``. Attention tiles are cut to
8 x 16 so that every chunked path runs several chunks, padding included.
Tolerances: losses and step metrics 1e-6 relative; attention outputs
and gradients within 1e-5 of each tensor's largest |x| (f32 sums in
another order than XLA's); the remat modes bit for bit. After 3 steps,
params within 1e-2 x lr: AdamW divides each element's first moment by
the root of its second, so an element whose gradient is small beside its
tensor's largest turns the gradients' f32 rounding into a move of up to
~0.5 % of lr (measured 4.5e-3 x lr, at lr 1e-3 and 1e-2 alike); the
moments, which carry the later steps' gradients, within 5e-5 of each
tensor's largest."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import ModelConfig as JaxConfig
from repro.models.steps import make_train_step as jax_train_step
from repro.optim import adamw as jadamw
from repro_torch.configs import get_smoke
from repro_torch.convert import opt_state_from_reference, \
    params_from_reference
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.schema import init_numpy
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw

ARCHS = ("smollm-360m", "recurrentgemma-2b", "mixtral-8x7b",
         "llama4-scout-17b-a16e", "granite-8b", "qwen1.5-0.5b", "qwen1.5-4b",
         "xlstm-350m", "hubert-xlarge", "qwen2-vl-72b")
# The 3-step state comparison's 1e-2 x lr bound on params is an empirical
# one (module doc): AdamW moves an element by its first moment over the
# root of its second, so an element whose gradient is ~1e-4 of its
# tensor's largest carries the f32 rounding of that gradient (~1e-6 of the
# largest) into its move at ~1 %. The SMOKE configs of the other five
# architectures have such elements (measured 1.08-1.42e-2 x lr in single
# elements of mlp.wi/wo, gradients within 1.5e-6 of each tensor's
# largest): their train steps are held here by the loss and every
# gradient, and by tests/test_torch_trainer.py's 4 Trainer steps (losses
# within 1e-6 relative).
STEP_ARCHS = ARCHS[:2]
TOL = 1e-5
LR = 1e-3


def cfg_of(arch, **kw):
    return get_smoke(arch).replace(compute_dtype="float32", use_kernels=False,
                                   attn_q_chunk=8, attn_kv_chunk=16, **kw)


def jax_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["use_pallas"] = fields.pop("use_kernels")
    return JaxConfig(**fields)


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def batch_of(cfg, shape, seed):
    """A numpy training batch: token ids, or for a frame model (HuBERT,
    no token embedding) frame embeddings and their labels."""
    if cfg.frontend != "audio_frames":
        return {"tokens": tokens(cfg, shape, seed)}
    g = np.random.default_rng(seed)
    return {"embeds": g.standard_normal((*shape, cfg.d_frontend)).astype(
        np.float32), "labels": tokens(cfg, shape, seed + 1)}


def grads_of(model):
    """{name: grad}; zeros for a leaf the loss does not reach (a token
    model's frontend_proj), as the reference's grad tree has them."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}


def model_of(cfg, tree):
    model = params_from_reference(tree, cfg, "cpu")
    model.requires_grad_(True)
    return model


def close_scaled(got, want, tol=TOL):
    """Within ``tol`` of the tensor's largest |x|."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def assert_tensors_close(got: dict, ref_tree, cfg, tol=TOL):
    """``got`` {port name: tensor} against a reference tree, mapped
    through ``params_from_reference``."""
    want = dict(params_from_reference(jax.tree.map(np.asarray, ref_tree),
                                      cfg, "cpu").named_parameters())
    assert set(got) == set(want)
    for name, t in got.items():
        close_scaled(t, want[name], tol)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy(masked):
    g = np.random.default_rng(0)
    logits = (g.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = g.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (g.random((3, 7)) > 0.4).astype(np.float32) if masked else None
    got = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          None if mask is None else torch.from_numpy(mask))
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 32), (30, 64)])
def test_chunked_lm_loss(s, chunk):
    cfg = cfg_of("smollm-360m")
    tree = init_numpy(cfg, 1)
    x = np.random.default_rng(2).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    labels = tokens(cfg, (2, s), 3)
    got = M.chunked_lm_loss(model_of(cfg, tree), cfg, torch.from_numpy(x),
                            torch.from_numpy(labels), chunk=chunk).detach()
    want = JM.chunked_lm_loss(jax.tree.map(jnp.asarray, tree), jax_cfg(cfg),
                              jnp.asarray(x), jnp.asarray(labels),
                              chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def qkv(b, sq, skv, h, hkv, hd, seed):
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd))]


@pytest.mark.parametrize("sq,causal,cq,ck", [(40, True, 8, 16),
                                             (37, True, 8, 16),
                                             (37, False, 16, 8),
                                             (21, True, 64, 64)])
def test_blocked_attention(sq, causal, cq, ck):
    arrs = qkv(2, sq, sq, 4, 2, 16, sq)
    kw = dict(causal=causal, window=0, q_offset=0, chunk_q=cq, chunk_kv=ck,
              scale=16 ** -0.5)
    got = A.blocked_attention(*map(torch.from_numpy, arrs), **kw)
    want = JA.blocked_attention(*map(jnp.asarray, arrs), **kw)
    close_scaled(got, want)
    plain = A.plain_attention(*map(torch.from_numpy, arrs), causal=causal,
                              window=0, scale=16 ** -0.5)
    close_scaled(got, plain)


@pytest.mark.parametrize("sq,window,cq", [(40, 16, 8), (37, 5, 8),
                                          (9, 16, 4), (30, 8, 64)])
def test_windowed_attention(sq, window, cq):
    arrs = qkv(2, sq, sq, 3, 1, 8, sq + window)
    kw = dict(window=window, chunk_q=cq, scale=8 ** -0.5)
    got = A.windowed_attention(*map(torch.from_numpy, arrs), **kw)
    want = JA.windowed_attention(*map(jnp.asarray, arrs), **kw)
    close_scaled(got, want)
    plain = A.plain_attention(*map(torch.from_numpy, arrs), causal=True,
                              window=window, scale=8 ** -0.5)
    close_scaled(got, plain)


def test_blocked_attention_gradients():
    """d(sum(out * w))/d(q, k, v) through the chunk checkpoints."""
    arrs = qkv(1, 37, 37, 4, 2, 16, 5)
    w = np.random.default_rng(6).standard_normal((1, 37, 4, 16)).astype(
        np.float32)
    kw = dict(causal=True, window=0, q_offset=0, chunk_q=8, chunk_kv=16,
              scale=0.25)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    (A.blocked_attention(*ts, **kw) * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda q, k, v: jnp.sum(
        JA.blocked_attention(q, k, v, **kw) * w), argnums=(0, 1, 2))(
        *map(jnp.asarray, arrs))
    for t, want in zip(ts, jg):
        close_scaled(t.grad, want)


# ---------------------------------------------------------------------------
# loss_fn and gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def grads_case(request):
    """(cfg, tree, batch, the JAX package's loss and grads)."""
    cfg = cfg_of(request.param)
    tree = init_numpy(cfg, 0)
    batch = batch_of(cfg, (2, 41), 7)
    loss, grads = jax.value_and_grad(lambda p: JM.loss_fn(
        p, jax_cfg(cfg), jax.tree.map(jnp.asarray, batch)))(
        jax.tree.map(jnp.asarray, tree))
    return cfg, tree, batch, float(loss), grads


def test_loss_fn_and_every_gradient(grads_case):
    cfg, tree, batch, jloss, jgrads = grads_case
    model = model_of(cfg, tree)
    loss = M.loss_fn(model, cfg, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-6)
    loss.backward()
    assert_tensors_close(grads_of(model), jgrads, cfg)


def test_loss_fn_with_pipeline_labels(grads_case):
    """Pipeline batches carry shifted labels: the same loss as shifting
    the token stream here. A frame model's batch carries its labels: its
    loss is the cross entropy of ``encode``'s logits."""
    cfg, tree, batch, jloss, _ = grads_case
    model = model_of(cfg, tree)
    if "tokens" in batch:
        t = torch.from_numpy(batch["tokens"])
        got = M.loss_fn(model, cfg, {"tokens": t[:, :-1],
                                     "labels": t[:, 1:]})
    else:
        logits = M.encode(model, cfg, torch.from_numpy(batch["embeds"]))
        got = L.cross_entropy(logits, torch.from_numpy(batch["labels"]))
    np.testing.assert_allclose(float(got.detach()), jloss, rtol=1e-6)


def test_embedding_backward_is_deterministic():
    """The lookup's gradient, with many repeated tokens and more than
    32k elements (where ``index_put_`` would add rows with atomics on
    the CPU), is the same bit for bit run to run."""
    cfg = cfg_of("smollm-360m").replace(d_model=64)
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (cfg.vocab_size, 64)).astype(np.float32)).requires_grad_()
    model = type("Emb", (), {"w": w})
    ids = torch.from_numpy(tokens(cfg, (8, 512), 1) % 7)   # 7 distinct ids
    up = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 512, 64)).astype(np.float32))
    grads = [torch.autograd.grad((L.embed_tokens(model, ids, cfg) * up)
                                 .sum(), w)[0] for _ in range(4)]
    assert all(torch.equal(g, grads[0]) for g in grads[1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_mode_refuses_the_kernels(arch):
    cfg = get_smoke(arch).replace(compute_dtype="float32")
    assert cfg.use_kernels
    model = model_of(cfg, init_numpy(cfg, 0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.loss_fn(model, cfg, {k: torch.from_numpy(v) for k, v in
                               batch_of(cfg, (1, 9), 0).items()})


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

REMATS = ("none", "full", "dots", "group:2")


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module", params=ARCHS)
def remat_runs(request):
    """Per remat mode: the loss, the grads and the matrix products the
    backward ran. 4 layers of one kind (RecurrentGemma: 6, two units of
    3), so
    ``group:2`` nests checkpoints of two units."""
    n_layers = 6 if request.param == "recurrentgemma-2b" else 4
    base = cfg_of(request.param, n_layers=n_layers)
    tree = init_numpy(base, 3)
    batch = {k: torch.from_numpy(v) for k, v in
             batch_of(base, (2, 33), 4).items()}
    out = {}
    for remat in REMATS:
        cfg = base.replace(remat=remat)
        model = model_of(cfg, tree)
        loss = M.loss_fn(model, cfg, batch)
        with _CountMM() as count:
            loss.backward()
        out[remat] = (loss.detach(), grads_of(model), count.mm)
    return out


@pytest.mark.parametrize("remat", REMATS[1:])
def test_remat_modes_bit_identical(remat_runs, remat):
    loss, grads, _ = remat_runs["none"]
    got_loss, got, _ = remat_runs[remat]
    assert torch.equal(got_loss, loss)
    for name, g in grads.items():
        assert torch.equal(got[name], g), name


def test_remat_recomputes_what_the_policy_says(remat_runs):
    """The backward reruns every layer's matrix products under ``full``
    and ``group:2`` (twice over, in the nested groups of SmolLM's 4
    layers) and none of them under ``dots``, which saved them."""
    mm = {r: remat_runs[r][2] for r in REMATS}
    assert mm["dots"] == mm["none"] < mm["full"] <= mm["group:2"]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(a, mb) for a in STEP_ARCHS
                                        for mb in (1, 2)],
                ids=lambda p: f"{p[0]}-mb{p[1]}")
def train_runs(request):
    """Three steps of the JAX package's ``make_train_step`` and the
    port's from one init: per-step metrics and the final state."""
    arch, mb = request.param
    cfg = cfg_of(arch, remat="dots")
    tree = init_numpy(cfg, 5)
    kw = dict(lr=LR, warmup_steps=2, total_steps=6)
    batches = [batch_of(cfg, (4, 25), 10 + i) for i in range(3)]
    step = jax.jit(jax_train_step(jax_cfg(cfg), jadamw.AdamWConfig(**kw),
                                  microbatches=mb))
    params = jax.tree.map(jnp.asarray, tree)
    opt = jadamw.init(params)
    jmetrics = []
    for b in batches:
        params, opt, m = step(params, opt, jax.tree.map(jnp.asarray, b))
        jmetrics.append({k: float(v) for k, v in m.items()})
    model = model_of(cfg, tree)
    state = adamw.init(dict(model.named_parameters()))
    port_step = make_train_step(cfg, adamw.AdamWConfig(**kw), microbatches=mb)
    metrics = [{k: float(v) for k, v in port_step(
        model, state, {k: torch.from_numpy(v) for k, v in b.items()}).items()}
        for b in batches]
    return cfg, (params, opt, jmetrics), (model, state, metrics)


def test_train_step_metrics(train_runs):
    _, (_, _, jmetrics), (_, _, metrics) = train_runs
    for got, want in zip(metrics, jmetrics):
        assert set(got) == set(want) == {"loss", "grad_norm", "lr"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=k)


def test_train_step_state(train_runs):
    """Params, m and v after 3 steps (and the step count)."""
    cfg, (params, opt, _), (model, state, _) = train_runs
    want = dict(params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                      "cpu").named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), rtol=0,
                                   atol=1e-2 * LR, err_msg=name)
    ref = opt_state_from_reference(jax.tree.map(np.asarray, opt.m),
                                   jax.tree.map(np.asarray, opt.v),
                                   opt.step, cfg, "cpu")
    assert int(state.step) == int(ref.step) == 3
    for name in ref.m:
        close_scaled(state.m[name], ref.m[name].numpy(), 5e-5)
        close_scaled(state.v[name], ref.v[name].numpy(), 5e-5)
