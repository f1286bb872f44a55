"""FOLD: ``plain`` (PyTorch) and ``cuda`` (CUDA kernel wrapper)."""
