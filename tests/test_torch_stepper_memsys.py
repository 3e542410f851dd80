"""The banked memory organizations under both fuse widths: the port's
``run_kernel`` against the JAX package's, exactly (final memory, cycles,
stats, steps). ``fuse`` only sets how often the port's host checks for
termination, so every width must give the same result."""
import pytest
from test_torch_parity import assert_same, configs

from repro.ggpu.engine import run_kernel as jax_run_kernel
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import run_kernel


@pytest.mark.parametrize("memsys", ["banked", "banked-iso"])
@pytest.mark.parametrize("fuse", [1, 4])
@pytest.mark.parametrize("bench,sizes", [("xcorr", (32, 256)),
                                         ("fir", (16, 64))])
def test_memsys_and_fuse(bench, sizes, memsys, fuse):
    b = programs.build(bench, *sizes)
    jcfg, cfg = configs(n_cus=2, memsys=memsys, fuse=fuse)
    args = (b.gpu_prog, b.gpu_mem, b.gpu_items)
    assert_same(run_kernel(*args, cfg, device="cpu"),
                jax_run_kernel(*args, jcfg), f"{bench}/{memsys}/{fuse}")
