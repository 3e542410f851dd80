"""Optimizers (the port's ``repro.optim``): AdamW as the reference
writes it (``adamw``) and int8 gradient compression with error feedback
(``compress``)."""
