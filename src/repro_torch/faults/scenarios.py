"""The ``FAULTS`` registry axis built-ins: named chaos scenarios (PyTorch
port of ``repro.faults.scenarios``).

A registered fault plugin is a factory ``(seed=0, **kw) ->
FaultScenario``: a :class:`~repro_torch.faults.plan.FaultPlan` bundled with
the serve-side resilience knobs that *answer* that fault class — the
retry policy that re-runs corrupted launches, the executor timeout that
surfaces a wedged device, the fleet resilience/hedging policy that
routes around it, and whether requests should carry output-checksum
audits (without audits a post-compute SEU is silent). The bundle is what
makes a scenario one registry lookup for CI: ``FAULTS.get("seu")(seed)``
hands a chaos bench everything it needs to build a fleet that should
*survive* the trace, and the gates then check that it did.

``FaultScenario.fleet_kwargs()`` plugs straight into ``Fleet(...)``;
``executor_wrap`` is the fleet hook that interposes one
:class:`~repro_torch.faults.inject.FaultInjector` per device. Injectors are
recorded on the scenario, so ``decision_log()`` is the merged, ordered
fault-decision record — the byte-comparable determinism surface.

Built-ins:

  * ``none`` — the control: no injection, no resilience machinery. A
    fleet built from it is the bit-exact baseline the chaos results are
    compared against.
  * ``seu`` — pre- and post-compute single-event upsets with checksum
    audits and bounded retries (corruption is caught and re-run, never
    served).
  * ``straggler`` — held completions with an executor timeout and
    deadline-aware hedging (the p99 insurance case).
  * ``device-loss`` — one device wedges permanently; the timeout +
    eviction machinery must re-route its backlog to the survivors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.faults.inject import FaultInjector
from repro_torch.faults.plan import FaultPlan
from repro_torch.registry import FAULTS
from repro_torch.serve.fleet import FleetResilience, HedgePolicy
from repro_torch.serve.scheduler import RetryPolicy


@dataclasses.dataclass
class FaultScenario:
    """One named chaos scenario: the fault plan plus the resilience
    configuration that answers it (module doc). ``audit`` asks the
    driver to stamp ``result_checksum`` audits on every request — the
    only way a post-compute SEU is detectable."""
    plan: FaultPlan
    retry: Optional[RetryPolicy] = None
    timeout_s: Optional[float] = None
    resilience: Optional[FleetResilience] = None
    audit: bool = False
    injectors: List[FaultInjector] = dataclasses.field(
        default_factory=list, repr=False)

    def executor_wrap(self, name: str, executor) -> FaultInjector:
        """The ``Fleet(executor_wrap=...)`` hook: interpose one injector
        per device (recorded here for ``decision_log``)."""
        inj = FaultInjector(name, executor, self.plan)
        self.injectors.append(inj)
        return inj

    def fleet_kwargs(self) -> dict:
        """Keyword arguments that configure a ``Fleet`` for this
        scenario — injection *and* the machinery expected to absorb it."""
        return dict(resilience=self.resilience, retry=self.retry,
                    timeout_s=self.timeout_s,
                    executor_wrap=self.executor_wrap)

    def decision_log(self) -> Tuple[tuple, ...]:
        """Every injection decision taken so far, merged across devices
        and canonically ordered — byte-identical across two runs with
        the same seed, plan, and trace (the determinism tests' surface)."""
        return tuple(sorted(
            entry for inj in self.injectors for entry in inj.injected))


@FAULTS.register("none")
def no_faults(seed: int = 0) -> FaultScenario:
    """The control scenario: nothing injected, nothing interposed."""
    return FaultScenario(FaultPlan(seed=seed))


@FAULTS.register("seu")
def seu(seed: int = 0, rate: float = 0.08,
        max_retries: int = 3) -> FaultScenario:
    """Single-event upsets on both sides of compute, with the audit +
    retry machinery that turns silent corruption into re-runs."""
    return FaultScenario(
        FaultPlan(seed=seed, seu_rate=rate / 2, seu_post_rate=rate),
        retry=RetryPolicy(max_retries=max_retries),
        resilience=FleetResilience(),
        audit=True)


@FAULTS.register("straggler")
def straggler(seed: int = 0, rate: float = 0.15,
              delay_s: float = 0.25,
              hedge_after_s: float = 0.05) -> FaultScenario:
    """Held completions: a fraction of chunks straggle by ``delay_s``;
    hedging duplicates their members onto healthy idle devices."""
    return FaultScenario(
        FaultPlan(seed=seed, straggler_rate=rate,
                  straggler_delay_s=delay_s),
        timeout_s=max(4 * delay_s, 1.0),
        resilience=FleetResilience(
            hedge=HedgePolicy(after_s=hedge_after_s)))


@FAULTS.register("device-loss")
def device_loss(seed: int = 0, device: str = "dev0",
                timeout_s: float = 0.25,
                stuck_after: int = 1) -> FaultScenario:
    """A device wedges permanently after ``stuck_after`` dispatches; the
    executor timeout surfaces it, retries exhaust, eviction re-routes
    its backlog to the survivors."""
    return FaultScenario(
        FaultPlan(seed=seed, stuck_devices=(device,),
                  stuck_after=stuck_after),
        retry=RetryPolicy(max_retries=1),
        timeout_s=timeout_s,
        resilience=FleetResilience(evict_after=2))
