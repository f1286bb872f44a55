"""FOLD: ``chain`` (the op chain), ``plain`` (the chain, as the contract
the kernels are held to) and ``cuda`` (CUDA kernel wrapper)."""
