"""Training runtime: optimizer, train/eval steps, resume checkpoints,
metrics and the learner."""
