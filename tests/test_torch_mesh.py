"""The port's mesh= sharding of the launch axis against the JAX package,
exactly: ``launch_shards`` and ``cohort_rows``, sharded cohorts over
``LaunchMesh(["cpu"] * k)`` for k in {1, 2, 3, 8} on all 8 benches (each
launch equal to the reference's direct ``run_kernel`` in memory, cycles,
instrs, mem_ops, hits, misses and steps, as tests/test_fleet_sharded.py
holds the reference's 8-way ``shard_map`` path), the sharded handle's
out_regions and device views, patches across shards, and a failure in a
padded dispatch named by the caller's index. Sharded batches are in
tests/test_torch_mesh_batch.py."""
import numpy as np
import pytest
import torch
from test_torch_parity import check_launch, small_benches, spinner, \
    variant_mem

from repro.ggpu.engine import BlockPatch as JaxBlockPatch
from repro.ggpu.engine import GGPUConfig as JaxConfig
from repro.ggpu.engine import KernelLaunchError as JaxLaunchError
from repro.ggpu.engine import XorBlockPatch as JaxXorBlockPatch
from repro.ggpu.engine import cohort_rows as jax_cohort_rows
from repro.ggpu.engine import run_kernel as jax_run_kernel
from repro.ggpu.engine import run_kernel_batch_async as jax_batch_async
from repro.ggpu.engine import run_kernel_cohort_async as jax_cohort_async
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import (BlockPatch, GGPUConfig,
                                     KernelLaunchError, XorBlockPatch,
                                     cohort_rows, launch_shards,
                                     run_kernel_batch_async,
                                     run_kernel_cohort,
                                     run_kernel_cohort_async)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import LaunchMesh, make_launch_mesh

CFG = GGPUConfig(n_cus=2)
JCFG = JaxConfig(n_cus=2)
SMALL = small_benches()
SHARDS = (1, 2, 3, 8)
# launches per bench: 5 and 6 leave padding on some shard counts and none
# on others (6 over 2 and 3)
N_LAUNCHES = {name: 5 + i % 2 for i, name in enumerate(sorted(SMALL))}


def cpu_mesh(k: int) -> LaunchMesh:
    return LaunchMesh(["cpu"] * k)


def test_launch_shards_and_cohort_rows_match_reference():
    for shards in SHARDS:
        for B in range(1, 41):
            assert cohort_rows(B, shards) == jax_cohort_rows(B, shards)
        assert launch_shards(cpu_mesh(shards)) == shards
    assert launch_shards(None) == 1
    with pytest.raises(TypeError, match="LaunchMesh"):
        launch_shards(object())


def test_launch_mesh_is_hashable_and_equal_by_devices(monkeypatch):
    a, b = cpu_mesh(3), LaunchMesh([torch.device("cpu")] * 3)
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a != cpu_mesh(2) and a.size == 3
    assert all(d == torch.device("cpu") for d in a.devices)
    with pytest.raises(AttributeError):
        a.devices = ()
    with pytest.raises(ValueError):
        LaunchMesh([])
    # make_launch_mesh takes the visible cards and never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_launch_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LaunchMesh(["cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh_mod.torch.cuda, "device_count", lambda: 2)
    assert make_launch_mesh().devices == (torch.device("cuda", 0),
                                          torch.device("cuda", 1))
    assert make_launch_mesh(1).size == 1
    with pytest.raises(ValueError):
        make_launch_mesh(3)


@pytest.fixture(scope="module")
def direct():
    """The JAX package's direct run of each bench's images."""
    cache = {}

    def get(name):
        if name not in cache:
            b = SMALL[name]()
            mems = [b.gpu_mem] + [variant_mem(b, s)
                                  for s in range(1, N_LAUNCHES[name])]
            cache[name] = (b, mems, [jax_run_kernel(b.gpu_prog, m,
                                                    b.gpu_items, JCFG)
                                     for m in mems])
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sharded_cohort_bit_exact(name, direct):
    """A cohort over k CPU mesh entries returns the reference's bits for
    every launch; padding rows (copies of the first image) never show."""
    b, mems, want = direct(name)
    B = len(mems)
    for k in SHARDS:
        h = run_kernel_cohort_async(b.gpu_prog, mems, b.gpu_items, CFG,
                                    mesh=cpu_mesh(k), device="cpu")
        assert len(h) == B and len(h.infos()) == B
        assert h._kind == ("shard-cohort" if k > 1 else "cohort")
        n_shards = len(h.staged) if k > 1 else 1
        assert n_shards == k
        assert h._b_local * k == (cohort_rows(B, k) if k > 1 else B)
        for i, (out, w) in enumerate(zip(h.results(), want)):
            check_launch(out, w)
            assert out[1]["batch_size"] == B
            np.testing.assert_array_equal(h.device_mem(i).numpy(), out[0])
    # the sync entry point and a one-launch cohort take the same path
    got = run_kernel_cohort(b.gpu_prog, mems[:1], b.gpu_items, CFG,
                            mesh=cpu_mesh(8), device="cpu")
    check_launch(got[0], want[0])


def test_shard_cohort_regions_and_device_views(direct):
    """out_regions (uniform, mixed, (0, 0)), device_mem and
    device_mem_block read each launch's own row across shards."""
    b, mems, want = direct("copy")
    B, n = len(mems), b.gpu_n
    lo, hi = b.gpu_out.start, b.gpu_out.stop
    mesh = cpu_mesh(3)
    h = run_kernel_cohort_async(b.gpu_prog, mems, b.gpu_items, CFG,
                                mesh=mesh, device="cpu",
                                out_regions=[(lo, hi)] * B)
    block = h.device_mem_block(0, 2 * n)
    assert tuple(block.shape) == (B, 2 * n)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(h.mem(i), np.asarray(w[0])[lo:hi])
        np.testing.assert_array_equal(block[i].numpy(),
                                      np.asarray(w[0])[:2 * n])
        np.testing.assert_array_equal(h.device_mem(i, (lo, hi)).numpy(),
                                      np.asarray(w[0])[lo:hi])
    with pytest.raises(IndexError):
        h.device_mem(B)
    regions = [(lo, hi), (0, 0), None, (0, 4), None]
    h = run_kernel_cohort_async(b.gpu_prog, mems, b.gpu_items, CFG,
                                mesh=mesh, device="cpu",
                                out_regions=regions)
    for i, (r, w) in enumerate(zip(regions, want)):
        full = np.asarray(w[0])
        expect = full if r is None else full[r[0]:r[1]]
        np.testing.assert_array_equal(h.mem(i), expect)
        assert h.info(i)["cycles"] == w[1]["cycles"]
    assert h.mem(1).shape == (0,)


def _chain_images(b, k):
    n = b.gpu_n
    prod = [variant_mem(b, 7 + j) for j in range(k)]
    cons = [np.zeros_like(b.gpu_mem) for _ in range(k)]
    flips = np.random.default_rng(5).integers(
        0, 2**31 - 1, (k, n)).astype(np.int32)
    flips[0] = 0
    return prod, cons, flips


@pytest.mark.parametrize("k", (3, 8))
def test_cross_shard_patches_equal_the_unsharded_reference_chain(k):
    """A producer cohort sharded k ways feeds a consumer cohort over the
    same mesh: shard 0's output patches the launch on shard k-1 (per-launch
    patch), a BlockPatch moves every row to the consumer's same row, an
    XorBlockPatch flips bits; each equals the JAX package's unsharded
    chain. The producer's memory is never written."""
    b = SMALL["copy"]()
    n = b.gpu_n
    mesh = cpu_mesh(k)
    prod, cons, flips = _chain_images(b, k)
    hp = run_kernel_cohort_async(b.gpu_prog, prod, b.gpu_items, CFG,
                                 mesh=mesh, device="cpu")
    before = hp.device_mem_block(0, b.gpu_mem.shape[0]).clone()
    jp = jax_cohort_async(b.gpu_prog, prod, b.gpu_items, JCFG)
    per = [None] * (k - 1) + [[(0, n, hp.device_mem(0, (n, 2 * n)))]]
    jper = [None] * (k - 1) + [[(0, n, jp.device_mem(0, (n, 2 * n)))]]
    cases = [(per, jper),
             (BlockPatch(0, n, hp.device_mem_block(n, 2 * n)),
              JaxBlockPatch(0, n, jp.device_mem_block(n, 2 * n))),
             (XorBlockPatch(0, n, torch.from_numpy(flips)),
              JaxXorBlockPatch(0, n, flips))]
    for patches, jpatches in cases:
        got = run_kernel_cohort_async(b.gpu_prog, cons, b.gpu_items, CFG,
                                      mesh=mesh, device="cpu",
                                      patches=patches)
        want = jax_cohort_async(b.gpu_prog, cons, b.gpu_items, JCFG,
                                patches=jpatches)
        for g, w in zip(got.results(), want.results()):
            check_launch(g, w)
    assert torch.equal(hp.device_mem_block(0, b.gpu_mem.shape[0]), before)


def test_max_steps_in_a_padded_sharded_dispatch_names_the_callers_index():
    """A launch that hits max_steps inside a padded sharded dispatch is
    named by its index in the caller's list, as the reference's unsharded
    run names it; fillers never fail and never show."""
    cfg, jcfg = GGPUConfig(n_cus=2, max_steps=50), \
        JaxConfig(n_cus=2, max_steps=50)
    b = programs._copy(8, 64)
    progs = [b.gpu_prog] * 3 + [spinner()] + [b.gpu_prog]
    mems = [b.gpu_mem] * 3 + [np.zeros(8, np.int32)] + [b.gpu_mem]
    items = [b.gpu_items] * 3 + [8] + [b.gpu_items]
    with pytest.raises(JaxLaunchError) as jexc:
        jax_batch_async(progs, mems, items, jcfg).results()
    for k in (2, 3, 8):
        h = run_kernel_batch_async(progs, mems, items, cfg,
                                   mesh=cpu_mesh(k), device="cpu")
        assert len(h) == 5
        for _ in range(2):                  # again on every call
            with pytest.raises(KernelLaunchError) as exc:
                h.results()
            assert exc.value.index == jexc.value.index == 3
    # a cohort whose every launch spins: the first is named, not a filler
    hc = run_kernel_cohort_async(spinner(), [np.zeros(8, np.int32)] * 3, 8,
                                 cfg, mesh=cpu_mesh(2), device="cpu")
    with pytest.raises(KernelLaunchError) as exc:
        hc.wait()
    assert exc.value.index == 0 and "cohort kernel 0" in str(exc.value)
