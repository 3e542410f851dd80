"""Drop-in scenario plugins — the one-file extension point.

Every module in this package is imported (sorted by file name) the first
time any registry axis is queried; a module registers its scenarios with
the axis decorators::

    from repro_torch.registry import TRAFFIC

    @TRAFFIC.register("my-pattern")
    def my_pattern(n, seed=0):
        ...

Nothing else is required: the new name resolves everywhere the axis is
consumed, and the registry smoke (``repro_torch.registry.smoke``) runs
it."""
import sys

from repro_torch.registry.core import scan_package

#: module names discovered in this package, in import order
DISCOVERED = scan_package(sys.modules[__name__])
