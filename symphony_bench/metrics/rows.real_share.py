"""rows.real_share: the real query rows of the window's paged steps over
the rows they computed (%).  A step runs its lanes at one power-of-two
bucket of lanes and of rows, so every lane pays the longest chunk's rows;
the real rows are each lane's new tokens (its context less its offset)."""
import numpy as np


def read(r):
    if not r.calls:
        return None
    real = sum(int(np.clip(c.ctx_lens.astype(np.int64)
                           - c.q_offsets.astype(np.int64), 0, None).sum())
               for c in r.calls)
    rows = sum(c.q_shape[0] * c.q_shape[1] for c in r.calls)
    return 100.0 * real / rows
