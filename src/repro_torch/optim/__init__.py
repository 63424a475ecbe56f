"""Optimizers and learning-rate schedules over plain tensor trees (port of
`repro.optim`, without the compression-aware optimizer wrapper)."""
