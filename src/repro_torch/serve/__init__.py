"""Serving (the port's ``repro.serve``): the LLM engine and the slot-wave
planner it admits requests with. The kernel-serving core (executors,
scheduler, fleet) is not ported yet (ROADMAP.md)."""
