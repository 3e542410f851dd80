"""The port's AdamW and int8 gradient compression against the JAX
package's, on the CPU, on the same numpy-seeded params and grads.

Tolerances: the schedule and the global norm within 1e-6 relative, the
updated params and moments within 1e-6 of each tensor's largest |x| (f32
pow, cos and sums in another order or precision than XLA's: the clip
scale differs by an ulp, and an element of m where b1*m and (1-b1)*g
nearly cancel keeps it as a larger relative error); compression exact,
ties at .5 included (both round half to even, and the rest is IEEE
division and products)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.optim import adamw, compress

RTOL = 1e-6


def tree(seed, shapes, scale=1.0):
    g = np.random.default_rng(seed)
    return {n: (g.standard_normal(s) * scale).astype(np.float32)
            for n, s in shapes.items()}


def torch_tree(t):
    return {n: torch.from_numpy(np.array(v)) for n, v in t.items()}


def close(got, want, rtol=RTOL, atol=0.0):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def close_scaled(got, want):
    """Within RTOL of the tensor's largest |x|."""
    want = np.asarray(want)
    close(got, want, rtol=0.0, atol=RTOL * float(np.abs(want).max()))


SHAPES = {"w": (16, 8), "b": (8,), "scale": (5,), "emb": (3, 4, 6)}


def test_schedule_every_step():
    hp = adamw.AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=20)
    jhp = jadamw.AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=20)
    for step in range(hp.total_steps + 6):
        got = adamw.schedule(hp, torch.tensor(step, dtype=torch.int32))
        want = jadamw.schedule(jhp, jnp.asarray(step, jnp.int32))
        close(got, want, atol=1e-12)


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e3])
def test_update_chained_steps(clip):
    """Five chained steps with a fresh grad each: params, m, v, step and
    the metrics, with the clip on (it binds), off, and on but slack."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, grad_clip=clip)
    hp, jhp = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    params = tree(0, SHAPES)
    p = torch_tree(params)
    state = adamw.init(p)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jadamw.init(jp)
    for i in range(5):
        grads = tree(10 + i, SHAPES, scale=3.0)
        metrics = adamw.update(torch_tree(grads), state, p, hp)
        jp, jstate, jm = jadamw.update(jax.tree.map(jnp.asarray, grads),
                                       jstate, jp, jhp)
        close(metrics["grad_norm"], jm["grad_norm"])
        close(metrics["lr"], jm["lr"])
        assert int(state.step) == int(jstate.step) == i + 1
        for n in SHAPES:
            close_scaled(p[n], jp[n])
            close_scaled(state.m[n], jstate.m[n])
            close_scaled(state.v[n], jstate.v[n])


def test_decay_follows_ndim_and_the_given_ndims():
    """Decay reaches the 2-D and 3-D tensors and not the 1-D ones; with
    ``ndims`` a 1-D tensor counted as 2-D is decayed as the reference
    decays a stacked layer's 1-D leaf."""
    hp = adamw.AdamWConfig(lr=1e-1, warmup_steps=0, total_steps=1,
                           weight_decay=0.5, grad_clip=0.0)
    params = {n: np.ones(s, np.float32) for n, s in SHAPES.items()}
    zero = {n: np.zeros(s, np.float32) for n, s in SHAPES.items()}
    p = torch_tree(params)
    adamw.update(torch_tree(zero), adamw.init(p), p, hp)
    jp, _, _ = jadamw.update(jax.tree.map(jnp.asarray, zero),
                             jadamw.init(params), params,
                             jadamw.AdamWConfig(**vars(hp)))
    for n in SHAPES:
        close(p[n], jp[n])
        assert bool((p[n] < 1).all()) == (len(SHAPES[n]) >= 2), n
    q = torch_tree(params)
    adamw.update(torch_tree(zero), adamw.init(q), q, hp, ndims={"b": 2})
    stacked = jnp.ones((1, 8), jnp.float32)   # b as a stacked layer leaf
    jb, _, _ = jadamw.update({"b": jnp.zeros((1, 8))},
                             jadamw.init({"b": stacked}), {"b": stacked},
                             jadamw.AdamWConfig(**vars(hp)))
    close(q["b"], jb["b"][0])
    assert bool((q["b"] < 1).all())


def test_global_norm():
    grads = tree(3, SHAPES, scale=7.0)
    close(adamw.global_norm(torch_tree(grads).values()),
          jadamw.global_norm(jax.tree.map(jnp.asarray, grads)))


def test_compress_three_steps_with_ties():
    """Three steps of error feedback, exact: each tensor's max sits at
    127 times a power of two, so g / scale lands on x.5 ties often."""
    g = np.random.default_rng(5)
    shapes = {"w": (32, 32), "v": (64,)}
    grads = []
    for _ in range(3):
        step = {}
        for n, s in shapes.items():
            x = (g.integers(-254, 255, s) / 2).astype(np.float32)
            x.flat[0] = 127.0                      # scale = 1: halves tie
            step[n] = x
        grads.append(step)
    state = compress.init(torch_tree(grads[0]))
    jstate = jcompress.init(jax.tree.map(jnp.asarray, grads[0]))
    ties = 0
    for step in grads:
        deq, state, stats = compress.compress_grads(torch_tree(step), state)
        jdeq, jstate, jstats = jcompress.compress_grads(
            jax.tree.map(jnp.asarray, step), jstate)
        assert stats == jstats
        for n in shapes:
            np.testing.assert_array_equal(deq[n].numpy(), np.asarray(jdeq[n]))
            np.testing.assert_array_equal(state.error[n].numpy(),
                                          np.asarray(jstate.error[n]))
            ties += int((np.abs(step[n]) % 1 == 0.5).sum())
    assert ties > 100


def test_compression_error_feedback():
    """The port of the reference's test: with error feedback the
    cumulative compressed signal tracks the cumulative true signal."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(0, 0.01, (64, 64)).astype(
        np.float32))
    grads = {"w": g_true}
    st_ = compress.init(grads)
    total_deq = torch.zeros_like(g_true)
    for _ in range(10):
        deq, st_, stats = compress.compress_grads(grads, st_)
        total_deq = total_deq + deq["w"]
    err = float((total_deq - 10 * g_true).abs().max())
    assert err < float(g_true.abs().max())
    assert stats["ratio"] == 4.0


def test_global_norm_holds_at_the_embeddings_size():
    """At SmolLM-360M's embedding size (49,152 x 960 f32) the norm stays
    within 1e-6 of the float64 value (a sum of squares taken in f32 in
    order, as the CPU's vector_norm takes it, drifts far more)."""
    x = np.random.default_rng(0).standard_normal(49_152 * 960,
                                                 np.float32) * 1e-3
    x[:1000] *= 100
    want = np.sqrt(np.sum(np.square(x, dtype=np.float64)))
    got = float(adamw.global_norm([torch.from_numpy(x)]))
    assert abs(got - want) / want < 1e-6
