"""Mean seconds of the window's joins (``join_stats``: host clock, each
ended by its first tokens' read-back), in ms."""


def read(run):
    j0, j1 = run.session.join0, run.session.join1
    n = j1["joins"] - j0["joins"]
    if n <= 0:
        return None
    total = j1["mean_join_s"] * j1["joins"] - j0["mean_join_s"] * j0["joins"]
    return total / n * 1e3
