"""Share of the traced window in which no operation ran on the device, in
percent: one less the union of the device ops' intervals over the
window's length."""


def read(w):
    if not w.trace or not w.trace["ops"]:
        return None
    t0, t1 = w.trace["window_ns"]
    return 100.0 * (1.0 - w.trace["busy_s"] / ((t1 - t0) / 1e9))
