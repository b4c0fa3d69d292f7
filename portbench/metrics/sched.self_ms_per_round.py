"""The host scheduler's own time a round (ms): the wall between two
successive round tops, minus the client hook's own time and the round's
``join`` and ``decode-segment`` spans (the batcher's tracer, traced runs
only), averaged over the window's rounds."""


def read(run):
    if not run.spans:
        return None
    by_round: dict[int, float] = {}
    for name, rnd, t0, t1 in run.spans:
        if name in ("join", "decode-segment"):
            by_round[rnd] = by_round.get(rnd, 0.0) + (t1 - t0)
    rounds = [r for r in run.session.rounds if not r.idle]
    own = []
    for a, b in zip(rounds, rounds[1:]):
        if run.w0 <= a.t and b.t <= run.w1:
            own.append(b.t - a.t - a.hook_s - by_round.get(a.round, 0.0))
    if not own:
        return None
    return sum(own) / len(own) * 1e3
