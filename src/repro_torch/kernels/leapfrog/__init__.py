"""Bounded search: ``plain`` (PyTorch) and ``cuda`` (CUDA kernel wrapper)."""
