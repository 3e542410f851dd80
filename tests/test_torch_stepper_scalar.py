"""Whole-machine parity on the scalar baseline (``ScalarConfig``: one lane,
one PE): every bench's sequential program at its smoke size through the
port and the JAX package, equal in memory, cycles, stats and steps."""
import pytest
from test_torch_parity import check_bench

from repro_torch.ggpu import programs


@pytest.mark.parametrize("name", programs.LEGACY_ORDER)
def test_scalar_bench_matches_reference(name):
    check_bench(name, 0)
