"""k1_roofline: kernel 1 (the fp paged attention) in the device trace: the
sum of its calls' bounds (``work.attention_work`` at each call's real rows
and contexts) over the sum of their kernels' device time (%)."""
from symphony_bench import work


def read(r):
    return work.attention_roofline(r)
