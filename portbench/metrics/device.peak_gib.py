"""The device memory the program held at most in the window, in GiB:
``torch.cuda.max_memory_allocated()`` after
``reset_peak_memory_stats()`` at the window's opening."""


def read(w):
    return w.peak_bytes / 2 ** 30 if w.peak_bytes else None
