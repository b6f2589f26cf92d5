"""Optimizer, training loop and single-experiment runner."""
