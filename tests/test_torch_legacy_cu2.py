"""The port's legacy stepper on the 2-CU G-GPU: the 8 benches of
tests/test_dse.py, each held to the port's fused run and to the JAX
package's legacy run (see test_torch_legacy.py)."""
import pytest
from test_torch_legacy import LEGACY_BENCHES, check_legacy


@pytest.mark.parametrize("name", sorted(LEGACY_BENCHES))
def test_legacy_cu2(name):
    check_legacy(name, 2, with_jax=True)
