"""The port's legacy stepper on the 8-CU G-GPU: the 8 benches of
tests/test_dse.py, each held to the port's fused run
(see test_torch_legacy.py)."""
import pytest
from test_torch_legacy import LEGACY_BENCHES, check_legacy


@pytest.mark.parametrize("name", sorted(LEGACY_BENCHES))
def test_legacy_cu8(name):
    check_legacy(name, 8, with_jax=False)
