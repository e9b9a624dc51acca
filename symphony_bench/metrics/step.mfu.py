"""step.mfu: the model FLOPs of the real tokens of the paged steps in the
window (``work.step_flops``: no padded row or lane is charged) over the
wall time they span at the card's bf16 peak (%).  The steps inside the
device trace, which the profiler slows, are left out, with their time."""
from symphony_bench import work


def read(r):
    if not r.on_card or not r.calls:
        return None
    a, b = r.t_trace if r.t_trace else (0.0, 0.0)
    flops = sum(work.step_flops(r.cfg, c.q_offsets, c.ctx_lens)
                for c in r.calls if not a <= c.t <= b)
    return 100.0 * flops / ((r.seconds - (b - a)) * work.PEAK_BF16_FLOPS)
