"""Roofline constants and model FLOPs (the part of the reference's
``repro.roofline`` that MeshPlanner reads), for one NVIDIA H100."""
