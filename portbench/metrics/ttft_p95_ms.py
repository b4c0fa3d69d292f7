"""The 95th percentile, over every request that arrived in the window, of
its scheduled arrival to the batcher's first-token stamp, in ms (host
clock).  A request that never got a first token counts as failed."""
import numpy as np


def read(run):
    s = run.session
    ttft = [q.t_first - q.t_arrival for q in s.window_reqs()
            if s.w0 <= q.t_arrival < s.w1 and q.t_first is not None]
    if not ttft:
        return None
    return float(np.percentile(ttft, 95)) * 1e3
