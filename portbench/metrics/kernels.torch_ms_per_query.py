"""Device milliseconds a query in every other device op of the traced
window: PyTorch's kernels (gathers, scatters, sorts, scans), copies and
memsets."""


def read(w):
    if not w.trace or not w.trace["ops"] or not w.queries:
        return None
    return 1e3 * w.trace["other_s"] / w.queries
