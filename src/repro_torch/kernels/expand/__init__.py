"""EXPAND: ``plain`` (PyTorch), ``cuda`` (CUDA kernel wrapper) and
``chain`` (the op-chain path, whose bounded searches take an ``impl``)."""
