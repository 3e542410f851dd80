"""Training (the port's ``repro.train``): atomic checkpoints
(``checkpoint``) and the fault-tolerant loop (``trainer``)."""
