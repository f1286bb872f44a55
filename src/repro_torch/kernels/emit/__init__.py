"""EMIT: ``chain`` (the op chain), ``plain`` (the chain, as the contract
the kernel is held to) and ``cuda`` (CUDA kernel wrapper)."""
