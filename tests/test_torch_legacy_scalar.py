"""The port's legacy stepper on the scalar baseline: the 8 benches of
tests/test_dse.py, each held to the port's fused run and to the JAX
package's legacy run (see test_torch_legacy.py)."""
import pytest
from test_torch_legacy import LEGACY_BENCHES, check_legacy


@pytest.mark.parametrize("name", sorted(LEGACY_BENCHES))
def test_legacy_scalar(name):
    check_legacy(name, "scalar", with_jax=True)
