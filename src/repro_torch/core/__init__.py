"""GPUPlanner's analytic half (the port's ``repro.core``): the SRAM macro
model (``sram``), the PPA estimator (``ppa``), the planner's map with
the 12-version Table I sweep (``planner``) and MeshPlanner, the same flow
retargeted at a training launch on the card (``meshplanner``). Pure
Python."""
