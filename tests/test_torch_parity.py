"""The parity harness the port's simulator tests share, and the tests of
``repro_torch.convert`` it rests on: one launch goes through the JAX
package and through the port (plain PyTorch on the CPU) on the same numpy
inputs, and everything observable must be equal."""
import dataclasses

import numpy as np

from repro.ggpu import programs as jax_programs
from repro.ggpu.engine import GGPUConfig as JaxConfig
from repro.ggpu.engine import ScalarConfig as JaxScalar
from repro.ggpu.engine import run_kernel as jax_run_kernel
from repro_torch.convert import bench_from_arrays, config_from_reference
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import run_kernel

STAT_KEYS = ("cycles", "instrs", "mem_ops", "hits", "misses", "steps")


def configs(scalar=False, **fields):
    """(JAX config, the port's config converted from it)."""
    ref = (JaxScalar if scalar else JaxConfig)(**fields)
    return ref, config_from_reference(dataclasses.asdict(ref), scalar)


def assert_same(got, want, what=""):
    """One launch's (mem, info) from the port equals the reference's."""
    (mem_t, info_t), (mem_j, info_j) = got, want
    np.testing.assert_array_equal(mem_t, np.asarray(mem_j), err_msg=what)
    for k in STAT_KEYS:
        assert info_t[k] == info_j[k], (what, k, info_t[k], info_j[k])
    assert info_t == info_j, what


def check_bench(name, cus):
    """Bench ``name`` at its smoke size on the scalar baseline (``cus`` 0)
    or a ``cus``-CU G-GPU (shared cache, fuse 4): the port equals the
    reference, and its output slice equals the bench's numpy reference."""
    ref_bench = getattr(jax_programs, f"_{name}")(*programs.SMOKE_SIZES[name])
    b = bench_from_arrays(**vars(ref_bench))
    if cus == 0:
        jcfg, cfg = configs(scalar=True)
        mem0, n, out = b.scalar_mem, b.scalar_n, b.scalar_out
        args = (b.scalar_prog, mem0, 1)
    else:
        jcfg, cfg = configs(n_cus=cus, fuse=4)
        mem0, n, out = b.gpu_mem, b.gpu_n, b.gpu_out
        args = (b.gpu_prog, mem0, b.gpu_items)
    got = run_kernel(*args, cfg, device="cpu")
    assert_same(got, jax_run_kernel(*args, jcfg), f"{name}/{cus}")
    np.testing.assert_array_equal(got[0][out], b.ref(mem0, n))


def test_config_from_reference_keeps_every_field():
    for scalar, fields in ((False, {}), (True, {}),
                           (False, {"n_cus": 8, "memsys": "banked-iso",
                                    "fuse": 1, "pipeline_depth": 2})):
        ref, ours = configs(scalar=scalar, **fields)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.issue_cycles == ref.issue_cycles
        assert type(ours).__name__ == type(ref).__name__


def test_bench_from_arrays_equals_the_port_builder():
    """A bench carried over from the reference equals the port's own copy
    of the builder, and its reference function is the port's."""
    for name in programs.LEGACY_ORDER:
        sizes = programs.SMOKE_SIZES[name]
        got = bench_from_arrays(**vars(getattr(jax_programs,
                                               f"_{name}")(*sizes)))
        ours = programs.build(name, *sizes)
        for field in ("gpu_prog", "gpu_mem", "scalar_prog", "scalar_mem"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(ours, field))
        assert (got.gpu_items, got.gpu_out, got.gpu_n) == \
            (ours.gpu_items, ours.gpu_out, ours.gpu_n)
        np.testing.assert_array_equal(got.ref(got.gpu_mem, got.gpu_n),
                                      ours.ref(ours.gpu_mem, ours.gpu_n))
