"""The port's scenario registry (``repro_torch.registry``): the copied
core (registration, duplicate and invalid names, lazy discovery, sorted
enumeration), the six axes with the same names as the JAX package's, the
drop-in plugins, the memsys mapping view, the bench specs, and the smoke
and one cross-product cell on the CPU path."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import registry as jax_registry
from repro.registry.plugins import DISCOVERED as JAX_DISCOVERED
from repro_torch.ggpu import programs
from repro_torch.ggpu.engine import GGPUConfig
from repro_torch.registry import (AXES, BENCHES, MEMSYS, SCENARIO_AXES,
                                  SCHEDULERS, TRAFFIC)
from repro_torch.registry import smoke
from repro_torch.registry.core import (Axis, DuplicateNameError,
                                       RegistryError, UnknownPluginError,
                                       resolve, scan_package)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _axis():
    return Axis("thing", providers=(), scan_plugins=False)


# -- core --------------------------------------------------------------------

def test_decorator_and_direct_registration():
    ax = _axis()

    @ax.register("deco")
    def plugin():
        return 1

    assert ax.register("direct", plugin) is plugin
    assert ax.get("deco") is plugin and ax.get("direct") is plugin


@pytest.mark.parametrize("bad", ["", None, 3])
def test_invalid_names_rejected(bad):
    with pytest.raises(RegistryError):
        _axis().register(bad, object())


def test_duplicates_unknowns_and_sorted_enumeration():
    ax = _axis()
    for name in ("zeta", "alpha", "mid"):
        ax.register(name, name.upper())
    with pytest.raises(DuplicateNameError, match="mid"):
        ax.register("mid", object())
    assert ax.names() == ["alpha", "mid", "zeta"] == list(ax)
    assert [n for n, _ in ax.items()] == ax.names()
    assert "mid" in ax and len(ax) == 3
    with pytest.raises(UnknownPluginError) as exc:
        ax.get("c")
    assert isinstance(exc.value, KeyError)
    assert "'alpha'" in str(exc.value) and "'zeta'" in str(exc.value)


def test_discovery_failure_reraises_on_retry():
    ax = Axis("broken", providers=("no_such_provider_module_xyz",),
              scan_plugins=False)
    for _ in range(2):
        with pytest.raises(ModuleNotFoundError):
            ax.names()


def test_resolve_and_scan_package(tmp_path, monkeypatch):
    assert resolve("json:dumps")([1]) == "[1]"
    with pytest.raises(RegistryError):
        resolve("json:no_such_attr")
    pkg = tmp_path / "dropin_pkg_xyz"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    for name in ("b_mod", "a_mod"):
        (pkg / f"{name}.py").write_text("LOADED = True\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    import dropin_pkg_xyz
    assert scan_package(dropin_pkg_xyz) == ["a_mod", "b_mod"]


def test_provider_import_is_lazy():
    """Importing the registry imports no provider; the first query of an
    axis does, and pulls in nothing of the JAX package."""
    code = (
        "import sys\n"
        "import repro_torch.registry as r\n"
        "assert 'repro_torch.serve.loadgen' not in sys.modules\n"
        "r.TRAFFIC.names()\n"
        "assert 'repro_torch.serve.loadgen' in sys.modules\n"
        "assert not [m for m in sys.modules if m == 'repro' or "
        "m.startswith(('repro.', 'jax'))]\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ,
                               "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr


# -- the axes ----------------------------------------------------------------

@pytest.mark.parametrize("axis", sorted(SCENARIO_AXES))
def test_axis_names_equal_the_reference(axis):
    """Every ported axis lists the reference's names, drop-in plugins
    included; every entry is the port's own object."""
    assert AXES[axis].names() == jax_registry.AXES[axis].names()
    assert AXES[axis].name == jax_registry.AXES[axis].name
    for _, obj in AXES[axis].items():
        mod = getattr(obj, "__module__", type(obj).__module__)
        assert mod.startswith("repro_torch."), mod


def test_axes_and_scenario_axes():
    assert set(AXES) == set(SCENARIO_AXES) == {
        "benches", "memsys", "schedulers", "routers", "traffic", "faults"}
    assert set(jax_registry.SCENARIO_AXES) == set(SCENARIO_AXES)


def test_dropin_plugins_discovered():
    from repro_torch.registry.plugins import DISCOVERED
    assert DISCOVERED == JAX_DISCOVERED
    assert "heavy-tail" in TRAFFIC and "deadline-drop" in SCHEDULERS
    arr = TRAFFIC.get("heavy-tail")(16, 3)
    assert len(arr) == 16 and np.all(np.diff(arr) >= 0)


def test_memsys_registry_view_tracks_axis():
    from repro_torch.ggpu.engine import MEMSYS_REGISTRY, get_memsys
    from repro_torch.ggpu.engine.memsys import BankedPerCUCache
    assert sorted(MEMSYS_REGISTRY) == MEMSYS.names() == list(MEMSYS_REGISTRY)
    assert len(MEMSYS_REGISTRY) == len(MEMSYS) == 3
    assert "shared" in MEMSYS_REGISTRY
    assert MEMSYS_REGISTRY["banked"] is MEMSYS.get("banked") \
        is get_memsys("banked")
    assert isinstance(get_memsys("banked-iso"), BankedPerCUCache)
    with pytest.raises(KeyError, match="choices"):
        get_memsys("l3-victim")


def test_bench_specs_build_the_port_benches():
    from repro_torch.registry.benches import LEGACY_ORDER, ordered_names
    assert ordered_names() == list(LEGACY_ORDER) == list(
        programs.all_benches())
    for name in LEGACY_ORDER:
        spec = BENCHES.get(name)
        assert spec.kernel_def is not None      # compiler.suite._DEFS
        assert spec.describe() == jax_registry.BENCHES.get(name).describe()
        assert spec.paper == (name in programs.PAPER_CYCLES)
        b = spec.build(*spec.smoke_sizes)
        want = programs.build(name, *programs.SMOKE_SIZES[name])
        np.testing.assert_array_equal(b.gpu_mem, want.gpu_mem)
        np.testing.assert_array_equal(b.gpu_prog, want.gpu_prog)
        assert spec.describe()["smoke_sizes"] == list(spec.smoke_sizes)


def test_policies_resolve_through_the_registry():
    from repro_torch.serve import Request, Scheduler, plan_chunks
    reqs = []
    for i, name in enumerate(("copy", "copy", "vec_mul", "div_int")):
        spec = BENCHES.get(name)
        b = spec.build(*spec.smoke_sizes)
        reqs.append(Request(b.gpu_prog, b.gpu_mem, b.gpu_items, f"r{i}",
                            priority=(1 if i == 3 else 0)))
    chunks = SCHEDULERS.get("fifo")(reqs, GGPUConfig(), 4)
    assert [tuple(c.members) for c in chunks] == [(0, 1), (2,), (3,)]
    assert SCHEDULERS.get("cohort") is plan_chunks
    assert tuple(plan_chunks(reqs, GGPUConfig(), 4)[0].members) == (3,)
    sched = Scheduler(GGPUConfig(), max_batch=4, device=CPU)
    assert sched.policy == "cohort"
    assert Scheduler(GGPUConfig(), policy=plan_chunks,
                     device=CPU)._plan is plan_chunks
    with pytest.raises(UnknownPluginError):
        Scheduler(GGPUConfig(), policy="no-such-policy", device=CPU)


# -- smoke and a cell on the CPU path ----------------------------------------

def test_selfcheck_and_smoke_all_find_no_problem():
    lines = []
    assert smoke.selfcheck(lines.append) == []
    assert len(lines) == len(AXES)
    assert smoke.smoke_all(lines.append, device=CPU) == []
    for axis in ("bench", "memsys", "policy", "router", "traffic", "fault"):
        assert any(line.startswith(f"smoke {axis} ") for line in lines), axis


def test_cell_under_seu_loses_nothing():
    lines = []
    assert smoke.run_cell("shared", "cohort", "earliest-finish",
                          lines.append, fault="seu", device=CPU) == []
    assert len(lines) == len(TRAFFIC)
