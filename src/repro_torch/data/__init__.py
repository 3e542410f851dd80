"""The token pipeline (the port's ``repro.data``): numpy batches as a
pure function of (seed, step), and their move onto the device."""
