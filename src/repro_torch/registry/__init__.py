"""Scenario registry (the port's ``repro.registry``): every pluggable axis
of the system, each an :class:`~repro_torch.registry.core.Axis` whose
built-ins register themselves from the named provider modules on first
query:

  ==============  =======================================  ==================
  axis            plugin contract                          built-ins from
  ==============  =======================================  ==================
  ``BENCHES``     :class:`~repro_torch.registry.benches.   repro_torch.
                  BenchSpec` (build a ``programs.Bench``   registry.benches
                  at given sizes)
  ``MEMSYS``      ``engine.memsys`` organization           repro_torch.ggpu.
                  instance (cycle model of a cache         engine.memsys
                  organization)
  ``SCHEDULERS``  chunk-planning policy:                   repro_torch.serve.
                  ``(requests, cfg, max_batch) ->          policies
                  List[Chunk]``
  ``ROUTERS``     fleet routing strategy *class*:          repro_torch.serve.
                  instances expose ``pick(fleet, req)      routing
                  -> FleetDevice``
  ``TRAFFIC``     arrival-trace generator:                 repro_torch.serve.
                  ``(n, seed=0) -> np.ndarray`` of         loadgen
                  seconds-from-start times
  ``FAULTS``      chaos-scenario factory:                  repro_torch.faults.
                  ``(seed=0, **kw) -> FaultScenario``      scenarios
  ==============  =======================================  ==================

Every axis also scans the ``repro_torch.registry.plugins`` drop-in
package, so a new scenario on any axis is one new file there; it resolves
by name everywhere (``GGPUConfig(memsys=...)``, ``Scheduler(policy=...)``,
``Fleet(router=...)``, ``FAULTS.get(...)``). Discovery never scans the
JAX package's plugins: the port's axes hold the port's objects only.

``AXES`` maps axis name -> axis for generic enumeration;
``SCENARIO_AXES`` is the scenario cross-product's subset (the same six
here: the reference's ``SECTIONS`` axis of benchmark-harness sections
waits for the port's benchmark entry points, ROADMAP.md queue item 10).
"""
from repro_torch.registry.core import (Axis, DuplicateNameError,
                                       RegistryError, UnknownPluginError)

BENCHES = Axis(
    "bench",
    doc="workloads: ISA benches",
    providers=("repro_torch.registry.benches",))

MEMSYS = Axis(
    "memsys",
    doc="memory-system cycle models (cache organizations)",
    providers=("repro_torch.ggpu.engine.memsys",))

SCHEDULERS = Axis(
    "scheduler",
    doc="chunk-planning policies for the continuous-batching core",
    providers=("repro_torch.serve.policies",))

ROUTERS = Axis(
    "router",
    doc="fleet placement strategies (router classes)",
    providers=("repro_torch.serve.routing",))

TRAFFIC = Axis(
    "traffic",
    doc="open-loop arrival-trace generators",
    providers=("repro_torch.serve.loadgen",))

FAULTS = Axis(
    "fault",
    doc="deterministic chaos scenarios (FaultScenario factories)",
    providers=("repro_torch.faults.scenarios",))

#: axis name -> axis; the generic enumeration surface
AXES = {
    "benches": BENCHES,
    "memsys": MEMSYS,
    "schedulers": SCHEDULERS,
    "routers": ROUTERS,
    "traffic": TRAFFIC,
    "faults": FAULTS,
}

SCENARIO_AXES = {k: AXES[k] for k in
                 ("benches", "memsys", "schedulers", "routers", "traffic",
                  "faults")}

__all__ = [
    "AXES", "BENCHES", "FAULTS", "MEMSYS", "ROUTERS", "SCENARIO_AXES",
    "SCHEDULERS", "TRAFFIC", "Axis", "DuplicateNameError", "RegistryError",
    "UnknownPluginError",
]
