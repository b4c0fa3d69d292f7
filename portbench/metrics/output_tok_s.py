"""Batch serving throughput: every output token the window emitted (up to
each request's drawn count), over the window's seconds (host clock)."""


def read(run):
    s = run.session
    tokens = sum(n - s.n_w0.get(rid, 0) for rid, n in s.n_w1.items())
    return tokens / run.window_s
