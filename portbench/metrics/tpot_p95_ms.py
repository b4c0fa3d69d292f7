"""The 95th percentile over requests of (last token - first token) /
(tokens - 1), in ms (host clock): the first token at the batcher's stamp,
the last when the client saw it at a round's top, over the requests that
finished inside the window."""
import numpy as np


def read(run):
    s = run.session
    done = [q for q in s.window_reqs() if q.t_done is not None
            and q.r.out_len > 1 and s.w0 <= q.t_done < s.w1]
    tpot = [(q.t_done - q.t_first) / (q.r.out_len - 1) for q in done]
    if not tpot:
        return None
    return float(np.percentile(tpot, 95)) * 1e3
