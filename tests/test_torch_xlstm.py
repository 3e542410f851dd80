"""xLSTM-350M in the port against the JAX package's, on the CPU, at f32
compute: the mLSTM and sLSTM blocks (prefill with and without a carried
state, padding to a chunk multiple, the decode step), the chunkwise form
against itself at other chunk sizes and against the per-step recurrence
(the replays of ``tests/test_models.py``'s two mLSTM tests), the
model's prefill followed by decode against a fresh prefill, the caches,
the config and AdamW's decay dims of the new leaves. Weights from
``schema.init_numpy`` and inputs from numpy, both seeded; the blocks
within 1e-5 (f32 sums in another order), the chunk-size and per-step
replays within the reference tests' 1e-4, a whole model's logits within
1e-4. ``Engine.generate`` against the JAX Engine is in
``tests/test_torch_llm.py``, loss and gradients in
``tests/test_torch_train.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.models import model as JM
from repro.models import recurrent as JR
from repro.models.config import ModelConfig as JaxConfig
from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import load_tree, params_from_reference
from repro_torch.models import model as M
from repro_torch.models import recurrent as R
from repro_torch.models.schema import init_numpy

ARCH = "xlstm-350m"
CFG = get_smoke(ARCH).replace(compute_dtype="float32", use_kernels=False)
TREE = init_numpy(CFG, seed=0)
UNIT = TREE["groups"]["0"]              # (mlstm, mlstm, mlstm, slstm)
ATOL = 1e-5


def jax_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["use_pallas"] = fields.pop("use_kernels")
    return JaxConfig(**fields)


def sub(tree, rep=0):
    return jax.tree.map(lambda x: np.asarray(x)[rep], tree)


def module(cls, tree):
    m = cls(CFG, "cpu")
    load_tree(m, tree)
    return m


def rand(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * np.float32(scale)
    return torch.from_numpy(x), jnp.asarray(x)


def close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _mlstm_states(b, seed):
    """A carried mLSTM state (port, JAX) at SMOKE width."""
    h, de = CFG.n_heads, 2 * CFG.d_model
    hd = de // h
    c, jc = rand((b, h, hd, hd), seed, 0.3)
    n, jn = rand((b, h, hd), seed + 1, 0.3)
    m, jm = rand((b, h), seed + 2)
    buf, jbuf = rand((b, 3, de), seed + 3)
    return (R.MLSTMState(c, n, m, R.ConvState(buf)),
            JR.MLSTMState(jc, jn, jm, JR.ConvState(jbuf)))


@pytest.mark.parametrize("s,with_state", [(13, False), (16, False),
                                          (13, True), (1, True)])
def test_mlstm_block(s, with_state):
    """S = 13 pads to two chunks of 8; S = 1 is the decode step (a chunk
    of 1)."""
    p = sub(UNIT["0"]["mixer"])
    m = module(R.MLSTMMixer, p)
    x, jxx = rand((2, s, CFG.d_model), 1)
    st, jst = _mlstm_states(2, 2) if with_state else (None, None)
    out, new = R.mlstm_block(m, x, CFG, st)
    jout, jnew = JR.mlstm_block(jax.tree.map(jnp.asarray, p), jxx,
                                jax_cfg(CFG), jst)
    close(out, jout)
    for got, want in zip(new[:3], jnew[:3]):
        close(got, want)
    close(new.conv.buf, jnew.conv.buf)


@pytest.mark.parametrize("s,with_state", [(13, False), (16, False),
                                          (13, True), (1, True)])
def test_slstm_block(s, with_state):
    """S = 16 runs 4 blocks of 4 steps; S = 13 blocks of 3 with two
    padded steps, which move the final state as in the reference. The
    carried state is the reference's after 7 other steps."""
    p = sub(UNIT["3"]["mixer"])
    jp = jax.tree.map(jnp.asarray, p)
    m = module(R.SLSTMMixer, p)
    x, jxx = rand((2, s, CFG.d_model), 3)
    st = jst = None
    if with_state:
        _, jst = JR.slstm_block(jp, rand((2, 7, CFG.d_model), 4)[1],
                                jax_cfg(CFG), None)
        st = R.SLSTMState(*(torch.from_numpy(np.array(t)) for t in jst))
    out, new = R.slstm_block(m, x, CFG, st)
    jout, jnew = JR.slstm_block(jp, jxx, jax_cfg(CFG), jst)
    close(out, jout)
    for got, want in zip(new, jnew):
        close(got, want)


def test_slstm_final_state_runs_the_padded_steps():
    """The reference's quirk, mirrored: a 13-step prefill leaves the
    state of 15 steps, the last two with zero input, not the state of 13
    single steps."""
    p = sub(UNIT["3"]["mixer"])
    m = module(R.SLSTMMixer, p)
    x, _ = rand((1, 13, CFG.d_model), 5)
    _, prefilled = R.slstm_block(m, x, CFG, None)
    st = None
    for t in range(13):
        _, st = R.slstm_block(m, x[:, t:t + 1], CFG, st)
    assert not torch.allclose(prefilled.c, st.c, atol=1e-3)
    hx = R.apply_norm(m.norm, x, CFG)
    gx = hx @ m.wg.w + m.bg
    carry = tuple(R.slstm_state_init(1, CFG.d_model, "cpu"))
    for g_t in list(gx[0]) + [torch.zeros_like(gx[0, 0])] * 2:
        carry = R.slstm_step(carry, g_t[None], m.rg)
    for got, want in zip(prefilled, carry):
        close(got, want)


def _scan_inputs(b, s, h, hd, seed):
    """q, k (scaled by hd^-0.5), v, logi, logf as (port, JAX) pairs."""
    g = np.random.default_rng(seed)
    q, k, v = (g.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    k *= np.float32(hd ** -0.5)
    logi = g.standard_normal((b, s, h)).astype(np.float32)
    f_pre = g.standard_normal((b, s, h)).astype(np.float32)
    logf = np.array(-jax.nn.softplus(-jnp.asarray(f_pre)))
    return [(torch.from_numpy(a), jnp.asarray(a))
            for a in (q, k, v, logi, logf)]


def test_mlstm_chunk_size_invariance():
    """The replay of tests/test_models.py:61: chunks of 4, 12 and 48 over
    48 steps agree within 1e-4; each equals the reference's scan at the
    same chunk within 1e-5, the final (C, n, m) too."""
    b, s, h, hd = 1, 48, 2, 8
    ins = _scan_inputs(b, s, h, hd, 6)
    st = R.mlstm_state_init(b, h, hd, 32, "cpu")
    jst = JR.mlstm_state_init(b, h, hd, 32)
    outs = []
    for chunk in (4, 12, 48):
        hs, state = R.mlstm_scan(*(t for t, _ in ins), st, chunk)
        jhs, jstate = JR.mlstm_scan(*(j for _, j in ins), jst, chunk)
        close(hs, jhs)
        for got, want in zip(state, jstate):
            close(got, want)
        outs.append(hs)
    close(outs[0], outs[1].numpy(), 1e-4)
    close(outs[0], outs[2].numpy(), 1e-4)


def test_mlstm_matches_stepwise_recurrence():
    """The replay of tests/test_models.py:80: the chunkwise-parallel form
    equals the xLSTM per-step definition (numpy, f64) within 1e-4."""
    b, s, h, hd = 1, 12, 1, 4
    ins = _scan_inputs(b, s, h, hd, 7)
    q, k, v, logi, logf = (t for t, _ in ins)
    hs, _ = R.mlstm_scan(q, k, v, logi, logf,
                         R.mlstm_state_init(b, h, hd, 8, "cpu"), chunk=s)
    C, n, m = np.zeros((hd, hd)), np.zeros(hd), R.LOG_EPS
    for t in range(s):
        mt = max(float(logf[0, t, 0]) + m, float(logi[0, t, 0]))
        fw = np.exp(float(logf[0, t, 0]) + m - mt)
        iw = np.exp(float(logi[0, t, 0]) - mt)
        kt, vt = k[0, t, 0].double().numpy(), v[0, t, 0].double().numpy()
        C = fw * C + iw * np.outer(kt, vt)
        n = fw * n + iw * kt
        m = mt
        qt = q[0, t, 0].double().numpy()
        want = (qt @ C) / max(abs(float(qt @ n)), np.exp(-m))
        close(hs[0, t, 0], want, 1e-4)


def test_mlstm_padding_keeps_the_state():
    """13 steps in chunks of 8 (3 padded steps, i-gate 2·LOG_EPS, f-gate
    1) carry the state of one chunk of 13 and give its outputs."""
    ins = _scan_inputs(2, 13, 2, 8, 8)
    st = R.mlstm_state_init(2, 2, 8, 32, "cpu")
    args = [t for t, _ in ins]
    padded, pst = R.mlstm_scan(*args, st, 8)
    whole, wst = R.mlstm_scan(*args, st, 13)
    assert padded.shape == (2, 13, 2, 8)
    close(padded, whole.numpy())
    for got, want in zip(pst, wst):
        close(got, want.numpy())


@pytest.fixture(scope="module")
def pair():
    tree = init_numpy(CFG, 1)
    return (params_from_reference(tree, CFG, "cpu"),
            jax.tree.map(jnp.asarray, tree))


def test_decode_after_prefill(pair):
    """Prefill 16 tokens (no sLSTM padding: blocks of 4), decode 5 with
    both packages: every step's logits within 1e-4; each step's logits
    also equal the last position of a fresh prefill of the tokens so far
    (the chunked and the recurrent forms carry the same state)."""
    model, jparams = pair
    jcfg = jax_cfg(CFG)
    toks = np.random.default_rng(9).integers(0, CFG.vocab_size, (2, 21))
    logits, cache = M.prefill(model, CFG, tokens=torch.from_numpy(
        toks[:, :16]))
    jlogits, jcache = JM.prefill(jparams, jcfg,
                                 tokens=jnp.asarray(toks[:, :16]))
    close(logits, jlogits, 1e-4)
    for t in range(16, 21):
        tok = torch.from_numpy(toks[:, t:t + 1])
        logits, cache = M.decode_step(model, CFG, cache, tok, t)
        jlogits, jcache = JM.decode_step(jparams, jcfg, jcache,
                                         jnp.asarray(toks[:, t:t + 1]), t)
        close(logits, jlogits, 1e-4)
        fresh, _ = M.prefill(model, CFG,
                             tokens=torch.from_numpy(toks[:, :t + 1]))
        close(logits, fresh.numpy(), 1e-4)


def test_init_cache_states():
    caches = M.init_cache(CFG, 3, 40, device="cpu")
    assert [type(c).__name__ for c in caches] == ["MLSTMState"] * 3 + [
        "SLSTMState"]
    h, de = CFG.n_heads, 2 * CFG.d_model
    assert caches[0].c.shape == (3, h, de // h, de // h)
    assert caches[0].conv.buf.shape == (3, 3, de)
    assert bool((caches[0].m == R.LOG_EPS).all())
    assert caches[3].h.shape == (3, CFG.d_model)
    assert bool((caches[3].m == R.LOG_EPS).all())
    jcaches = JM.init_cache(jax_cfg(CFG), 3, 40)["0"]
    for i in range(4):
        for got, want in zip(jax.tree.leaves(tuple(caches[i])),
                             jax.tree.leaves(jcaches[str(i)])):
            close(got, np.asarray(want)[0], 0)


def test_decay_ndims_of_the_new_leaves():
    """AdamW's decay rule reads each leaf's ndim in the reference's
    stacked tree: the port's ``decay_ndims`` gives the same, rg's 4
    among them."""
    ndims = jax.tree.map(lambda x: np.full(x.shape, x.ndim, np.float32),
                         TREE)
    model = params_from_reference(ndims, CFG, "cpu")
    nd = M.decay_ndims(model)
    for name, p in model.named_parameters():
        assert nd[name] == int(p.flatten()[0]), name
    assert nd["layers.3.mixer.rg"] == 4


def test_config_equals_the_reference():
    for ours, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_smoke(ARCH), jax_smoke(ARCH))):
        a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        assert a.pop("use_kernels") is True and b.pop("use_pallas") is False
        assert a == b
        assert ours.n_params() == theirs.n_params()
    assert get_config(ARCH).n_params() == 481_076_224          # 481.1 M
