"""Checkpoints, the weight bridge from the JAX parameter trees, logging
and image visualizations."""
