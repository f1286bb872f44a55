"""Flash attention: ``ref`` (dense oracle), ``plain`` (blocked online
softmax in PyTorch), ``cuda`` (the CUDA kernel's wrapper) and ``ops``
(the dispatch the model calls)."""
