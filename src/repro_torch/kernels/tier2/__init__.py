"""Tier-2 table ops: ``plain`` (the PyTorch op chains, run on CPU tensors)
and ``cuda`` (the wrappers around ``csrc/tier2.cu``, run on CUDA
tensors), both reached through ``core/cache.py``'s ``_probe``,
``_probe_payload`` and ``_insert``."""
