"""Training: the optimizer, the synthetic data, checkpoints and the loop."""
