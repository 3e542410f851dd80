"""The port's entry points against the JAX package's, exactly: pipeline
depth, divergence, ragged wavefronts, cohorts, heterogeneous batches and
the max_steps error (memory organizations: test_torch_stepper_memsys.py)."""
import numpy as np
import pytest
from test_torch_parity import assert_same, configs

from repro.ggpu.engine import KernelLaunchError as JaxLaunchError
from repro.ggpu.engine import run_kernel as jax_run_kernel
from repro.ggpu.engine import run_kernel_batch as jax_run_kernel_batch
from repro.ggpu.engine import run_kernel_cohort as jax_run_kernel_cohort
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import (KernelLaunchError, run_kernel,
                                     run_kernel_batch, run_kernel_cohort)
from repro_torch.ggpu.isa import Assembler


def _divergent_prog(n):
    """tests/test_engine.py's divergent kernel: odd and even items take
    different paths and reconverge at the halt."""
    a = Assembler()
    a.tid(1).andi(2, 1, 1).beq(2, 0, "even")
    a.mul(3, 1, 1).sw(3, 1, n).beq(0, 0, "end")
    a.label("even").slli(3, 1, 1).sw(3, 1, n)
    a.label("end").halt()
    return a.assemble()


def _both(prog, mem, n, **fields):
    jcfg, cfg = configs(**fields)
    got = run_kernel(prog, mem, n, cfg, device="cpu")
    assert_same(got, jax_run_kernel(prog, mem, n, jcfg), str(fields))
    return got


@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_depth(depth):
    b = programs.build("fir", *programs.SMOKE_SIZES["fir"])
    mem, info = _both(b.gpu_prog, b.gpu_mem, b.gpu_items, n_cus=2,
                      pipeline_depth=depth)
    base = run_kernel(b.gpu_prog, b.gpu_mem, b.gpu_items,
                      configs(n_cus=2)[1], device="cpu")[1]
    assert info["cycles"] > base["cycles"]


def test_divergent_program():
    n = 128
    mem, _ = _both(_divergent_prog(n), np.zeros(2 * n, np.int32), n, n_cus=2)
    i = np.arange(n)
    np.testing.assert_array_equal(mem[n:], np.where(i % 2, i * i, 2 * i))


def test_ragged_wavefronts_over_resident_limit():
    """More wavefronts than CUs can hold, not a multiple of the CU count:
    the ranking runs and W is rounded up with always-done wavefronts."""
    b = programs.build("copy", 32, 1000)
    _both(b.gpu_prog, b.gpu_mem, b.gpu_items, n_cus=3, max_wf_per_cu=2)


def test_cohort_matches_reference():
    b = programs.build("xcorr", 16, 64)
    rng = np.random.default_rng(11)
    mems = [np.concatenate([rng.integers(-20, 20, 128).astype(np.int32),
                            np.zeros(64, np.int32)]) for _ in range(3)]
    jcfg, cfg = configs(n_cus=2)
    got = run_kernel_cohort(b.gpu_prog, mems, b.gpu_items, cfg, device="cpu")
    want = jax_run_kernel_cohort(b.gpu_prog, mems, b.gpu_items, jcfg)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"cohort {i}")
        assert g[1]["batch_size"] == 3


def test_batch_matches_reference_mixed_shapes():
    """Mixed programs, memory sizes and item counts; each launch's address
    clip binds at its own memory size (the copy reads past its end)."""
    c = programs.build("copy", 64, 1024)
    f = programs.build("fir", 16, 64)
    over = Assembler()
    over.tid(1).lw(2, 1, 100).sw(2, 1, 0).halt()     # reads clip at 63
    n = 128
    launches = [
        (c.gpu_prog, c.gpu_mem, c.gpu_items),
        (_divergent_prog(n), np.zeros(2 * n, np.int32), n),
        (f.gpu_prog, f.gpu_mem, f.gpu_items),
        (over.assemble(), np.arange(64, dtype=np.int32), 40),
    ]
    jcfg, cfg = configs(n_cus=2)
    args = [list(x) for x in zip(*launches)]
    got = run_kernel_batch(*args, cfg, device="cpu")
    want = jax_run_kernel_batch(*args, jcfg)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"batch {i}")
        single = run_kernel(*launches[i], cfg, device="cpu")
        w_info = {k: v for k, v in w[1].items() if k != "batch_size"}
        assert_same(single, (w[0], w_info), f"single {i}")
    np.testing.assert_array_equal(got[3][0][:40], np.full(40, 63))


def test_kernel_launch_error_names_the_launch():
    """A launch that cannot halt within max_steps raises with its index,
    as the reference does."""
    spin = Assembler()
    spin.label("top").beq(0, 0, "top").halt()
    ok = programs.build("copy", *programs.SMOKE_SIZES["copy"])
    jcfg, cfg = configs(n_cus=1, max_steps=40)
    progs = [ok.gpu_prog, spin.assemble()]
    mems = [ok.gpu_mem, np.zeros(4, np.int32)]
    with pytest.raises(KernelLaunchError) as err:
        run_kernel_batch(progs, mems, [ok.gpu_items, 4], cfg, device="cpu")
    with pytest.raises(JaxLaunchError) as jerr:
        jax_run_kernel_batch(progs, mems, [ok.gpu_items, 4], jcfg)
    assert err.value.index == jerr.value.index == 1
    with pytest.raises(KernelLaunchError) as err:
        run_kernel(spin.assemble(), np.zeros(4, np.int32), 4, cfg,
                   device="cpu")
    assert err.value.index == 0
    b = programs.build("fir", *programs.SMOKE_SIZES["fir"])
    mems = [b.gpu_mem, b.gpu_mem]
    with pytest.raises(KernelLaunchError) as err:
        run_kernel_cohort(b.gpu_prog, mems, b.gpu_items, cfg, device="cpu")
    with pytest.raises(JaxLaunchError) as jerr:
        jax_run_kernel_cohort(b.gpu_prog, mems, b.gpu_items, jcfg)
    assert err.value.index == jerr.value.index == 0
