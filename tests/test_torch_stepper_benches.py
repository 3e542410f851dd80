"""Whole-machine parity on the G-GPU: every bench at its smoke size through
the port's ``run_kernel`` (plain PyTorch on the CPU) and the JAX
``run_kernel`` on 1/2/4/8-CU G-GPUs (shared cache, fuse 4). Final memory,
cycles, instrs, mem_ops, hits, misses and steps must be equal."""
import pytest
from test_torch_parity import check_bench

from repro_torch.ggpu import programs


@pytest.mark.parametrize("cus", [1, 2, 4, 8])
@pytest.mark.parametrize("name", programs.LEGACY_ORDER)
def test_bench_matches_reference(name, cus):
    check_bench(name, cus)
