"""engine.step_ms: the mean wall time of one ``NodeEngine.step`` in the
window, by the benchmark's clock around each call (ms).  The steps inside
the device trace, which the profiler slows, are left out."""


def read(r):
    return 1e3 * sum(r.step_s) / len(r.step_s) if r.step_s else None
