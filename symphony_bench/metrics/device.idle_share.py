"""device.idle_share: the share of the traced part of the window in which
no operation ran on the card (%)."""
from symphony_bench import tracing


def read(r):
    if not r.on_card or not r.trace_s:
        return None
    busy = tracing.busy_seconds(r.events, *r.t_trace)
    return 100.0 * (1.0 - busy / r.trace_s)
