"""Roofline constants for one NVIDIA H100, model FLOPs, the step-cost
counter (``counter.StepCost``) and the roofline of a counted step
(``analysis.analyze``)."""
