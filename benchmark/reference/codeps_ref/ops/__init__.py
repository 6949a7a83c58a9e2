"""Tensor ops of the frozen copy (plain PyTorch, no kernel)."""
