"""Training: the step, the loop, checkpoints and the schedule."""
