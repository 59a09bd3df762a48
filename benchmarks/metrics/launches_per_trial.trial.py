"""Device operations per trial: the kernels, copies and memsets the
profiler saw on the card inside the measured window, over the window's
trials."""


def read(rec):
    if rec.trace is None or not rec.units:
        return None
    n = rec.trace.n_device_ops()
    return n / len(rec.units) if n else None
