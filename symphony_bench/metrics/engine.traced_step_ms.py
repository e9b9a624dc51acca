"""engine.traced_step_ms: the mean wall time of one ``NodeEngine.step``
inside the device trace (ms), beside ``engine.step_ms`` outside it: the two
apart are what the profiler costs, and say how far the traced interval's
idle share stands for the untraced window."""


def read(r):
    s = r.traced_step_s
    return 1e3 * sum(s) / len(s) if s else None
