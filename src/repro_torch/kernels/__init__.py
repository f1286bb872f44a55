"""Device-kernel layer.  Every join kernel is reached through
``registry``, the tier-2 table ops through ``core/cache.py``; each kernel
package keeps ``plain.py`` (the PyTorch version, run on CPU
tensors) and ``cuda.py`` (the wrapper around the CUDA kernel in
``repro_torch/csrc``, run on CUDA tensors).

  * ``expand/``   — frontier expansion (fused kernel, or the op chain)
  * ``leapfrog/`` — bounded search, the chain EXPAND's membership test
  * ``fold/``     — evaluation-mode FOLD, three arities
  * ``emit/``     — stable valid-row EMIT pack
  * ``tier2/``    — the tier-2 tables' probe and insert
"""
