"""Optimizers, learning-rate schedules and gradient compression over plain
tensor trees (port of `repro.optim`)."""
