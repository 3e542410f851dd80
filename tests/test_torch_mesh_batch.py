"""The port's sharded heterogeneous batches against the JAX package,
exactly: ``run_kernel_batch(_async)`` over ``LaunchMesh(["cpu"] * k)``
for k in {1, 2, 3, 8} on all 8 benches, padded with 1-item HALT fillers
that never show; out_regions, per-launch patches across shards and the
device views of a sharded batch (the cohort side is
tests/test_torch_mesh.py)."""
import numpy as np
import pytest
import torch
from test_torch_parity import check_launch, pad_prog, small_benches, \
    variant_mem

from repro.ggpu.engine import GGPUConfig as JaxConfig
from repro.ggpu.engine import run_kernel as jax_run_kernel
from repro.ggpu.engine import run_kernel_batch_async as jax_batch_async
from repro_torch.ggpu.engine import (GGPUConfig, run_kernel_batch,
                                     run_kernel_batch_async)
from repro_torch.launch.mesh import LaunchMesh

CFG = GGPUConfig(n_cus=2)
JCFG = JaxConfig(n_cus=2)
SMALL = small_benches()
SHARDS = (1, 2, 3, 8)


def cpu_mesh(k: int) -> LaunchMesh:
    return LaunchMesh(["cpu"] * k)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sharded_batch_bit_exact(name):
    """Five launches of three programs (the bench's and two HALT-padded
    twins, which behave as it does) and three memory sizes over k CPU
    mesh entries return the reference's direct bits for every launch."""
    b = SMALL[name]()
    M = b.gpu_mem.shape[0]
    mems = [b.gpu_mem, variant_mem(b, 1), variant_mem(b, 2),
            np.concatenate([variant_mem(b, 3), np.zeros(5, np.int32)]),
            variant_mem(b, 4)]
    progs = [b.gpu_prog, pad_prog(b.gpu_prog, 1), b.gpu_prog,
             pad_prog(b.gpu_prog, 3), b.gpu_prog]
    want = [jax_run_kernel(b.gpu_prog, m, b.gpu_items, JCFG) for m in mems]
    for k in SHARDS:
        h = run_kernel_batch_async(progs, mems, [b.gpu_items] * 5, CFG,
                                   mesh=cpu_mesh(k), device="cpu")
        assert len(h) == 5 and h._kind == "batch"
        assert h._b_local * k == 5 + (-5 % k if k > 1 else 0)
        for i, (out, w) in enumerate(zip(h.results(), want)):
            check_launch(out, w)
            assert out[0].shape == (mems[i].shape[0],)
            assert out[1]["batch_size"] == 5
        np.testing.assert_array_equal(
            h.device_mem_block(0, M).numpy(),
            np.stack([np.asarray(w[0])[:M] for w in want]))
    got = run_kernel_batch(progs[:1], mems[:1], [b.gpu_items], CFG,
                           mesh=cpu_mesh(8), device="cpu")
    check_launch(got[0], want[0])


def test_sharded_batch_regions_and_patches_equal_reference():
    """Mixed out_regions and per-launch patch lists (one from a producer
    launch on another shard) on a batch sharded 3 ways equal the JAX
    package's unsharded batch with the same patches."""
    b = SMALL["copy"]()
    n = b.gpu_n
    progs = [b.gpu_prog, pad_prog(b.gpu_prog, 1)] * 2 + [b.gpu_prog]
    mems = [variant_mem(b, s) for s in range(5)]
    items = [b.gpu_items] * 5
    mesh = cpu_mesh(3)
    src = np.random.default_rng(4).integers(-50, 50, n).astype(np.int32)
    hp = run_kernel_batch_async(progs, mems, items, CFG, mesh=mesh,
                                device="cpu")
    jp = jax_batch_async(progs, mems, items, JCFG)
    patches = [None, [(0, n, src)], None, [(4, 8, src[:4], "xor")],
               [(0, n, hp.device_mem(0, (n, 2 * n)))]]
    jpatches = patches[:4] + [[(0, n, jp.device_mem(0, (n, 2 * n)))]]
    regions = [(n, 2 * n), (0, 0), None, (0, 4), (n, 2 * n)]
    got = run_kernel_batch_async(progs, mems, items, CFG, mesh=mesh,
                                 device="cpu", patches=patches,
                                 out_regions=regions)
    want = jax_batch_async(progs, mems, items, JCFG, patches=jpatches,
                           out_regions=regions)
    for g, w in zip(got.results(), want.results()):
        check_launch(g, w)
    assert got.mem(1).shape == (0,)
    # the producer launch on shard 0 kept its memory
    np.testing.assert_array_equal(hp.mem(0), np.asarray(jp.mem(0)))
    with pytest.raises(ValueError):
        run_kernel_batch_async(progs, mems, items, CFG, mesh=mesh,
                               device="cpu", patches=patches[:3])
    assert torch.equal(hp.device_mem(4), torch.from_numpy(hp.mem(4)))
