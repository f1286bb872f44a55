"""Device milliseconds a query in the program's own CUDA kernels (those
defined in ``src/repro_torch/csrc``), from the traced window's raw
kineto events."""


def read(w):
    if not w.trace or not w.trace["ops"] or not w.queries:
        return None
    return 1e3 * w.trace["port_s"] / w.queries
