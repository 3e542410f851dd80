"""GPUPlanner's analytic half (the port's ``repro.core``): the SRAM macro
model (``sram``), the PPA estimator (``ppa``) and the planner's map with
the 12-version Table I sweep (``planner``). Pure Python."""
