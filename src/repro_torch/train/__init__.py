"""Training utilities: the optimizer and the LR schedules."""
