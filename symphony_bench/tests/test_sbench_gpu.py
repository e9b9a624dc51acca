"""The device trace on the card: events on the host's clock, inside the
traced interval, and the busy time no longer than it."""
import time

import pytest
import torch

from symphony_bench import tracing


@pytest.mark.gpu
def test_device_trace_reads_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()

    def clock():
        return time.perf_counter() - t0
    tr = tracing.DeviceTrace(clock)
    tr.warm(dev)
    tr.start(dev)
    a = torch.randn(2048, 2048, device=dev)
    for _ in range(20):
        a = a @ a
        a = a / a.norm()
    time.sleep(0.05)
    tr.stop(dev)
    ev = tr.events()
    assert ev and all(tr.t_start - 1e-3 <= s <= e <= tr.t_stop + 1e-3
                      for _, s, e in ev)
    busy = tracing.busy_seconds(ev, tr.t_start, tr.t_stop)
    assert 0 < busy <= tr.t_stop - tr.t_start
    gaps = tracing.idle_gaps(ev, tr.t_start, tr.t_stop, [])
    assert gaps[0][1] >= 0.04           # the sleep, named by no span
