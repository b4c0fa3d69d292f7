"""How ``correct`` is decided: the served tokens against the plain
reference.

Once the window has closed and the batcher is freed, a sample of the
requests the program finished, drawn from the seed with the longest of
them in it, is run through the cell's float32 reference (the module its
configuration names, ``reference/model.py`` by default; the contract is
in ``reference/__init__.py``) over each prompt and its served tokens.
At each served position the gap is how far the served token's logit lies
below the reference's best, in units of the standard deviation of the
reference's logits there (greedy decoding serves the argmax, so a sound
program reads rounding alone).  The numbers compared are the widest gap
and the mean gap, each where the cell's limits file gives it a limit
(``limits/<workload>.json``, with the readings it was set from).  The
joins (first tokens), the graphed decode segments (every later token),
the paged pool they read and the read-out are all in it.

Capacity: a routed-expert layer of the port gives each expert
``int(T k cf / E)`` places a call, T every row and position of the call,
and drops the choices past them in token-major order, so a row's experts
depend on the rows before it, which the reference cannot see.  The rows
of the first slots never reach a place past the capacity: a decode step
has ``B`` tokens and a join ``B W``, and slot s has at most s (decode)
or s W + W - 1 (a join of width W) tokens before any of its own, one
choice of an expert each.  :func:`undroppable_slots` counts them; for an
MoE configuration the sample is drawn from requests served in those
slots, whose every choice the program computed, and the reference routes
them without dropping.
"""
from __future__ import annotations

import numpy as np
import torch


def undroppable_slots(port: dict, slots: int, max_len: int) -> int:
    """How many leading slots no capacity drop can reach, at ``slots``
    rows and join widths up to ``max_len``."""
    moe = port.get("moe")
    if not moe:
        return slots
    e, k, cf = moe["n_experts"], moe["top_k"], moe["capacity_factor"]
    n = max(1, int(slots * k * cf / e))          # decode: rank <= s
    width = 8
    while True:
        w = min(width, max_len)
        places = max(1, int(slots * w * k * cf / e))
        n = min(n, places // w)                  # join: (s + 1) W <= C
        if w >= max_len:
            break
        width *= 2
    return min(n, slots)


def sample(session, seed: int, k: int, port: dict, min_tokens: int = 0):
    """The requests to compare, all served in an undroppable slot: the
    longest (prompt and output) finished request of the window's (the
    arrivals of an open loop, the completions of a backlog), then the
    window's other finished requests, the earlier finished ones and the
    ones in flight when the window closed (their tokens served so far),
    each group in an order drawn from the seed, until there are ``k``
    and they served ``min_tokens`` tokens (or none is left).  A backlog's
    requests outlive its window, so few of the first slots' may finish
    in it."""
    mix = session.mix
    ok_slots = undroppable_slots(port, mix.slots, mix.max_len)
    served = sorted((q for q in session.window_reqs()
                     if q.served and q.slot is not None and q.slot < ok_slots),
                    key=lambda q: q.r.rid)
    done = [q for q in served if q.t_done is not None]
    if mix.kind == "open":
        mine = [q for q in done if session.w0 <= q.t_arrival < session.w1]
    else:
        mine = [q for q in done if q.t_done >= session.w0]
    if not done:
        return []
    longest = max(mine or done,
                  key=lambda q: (q.plen + q.r.out_len, -q.r.rid))
    rng = np.random.default_rng(int(seed) + 7)
    order = [longest]
    for group in (mine, [q for q in done if q not in mine],
                  [q for q in served if q.t_done is None]):
        rest = [q for q in group if q is not longest]
        order += [rest[i] for i in rng.permutation(len(rest))]
    out, tokens = [], 0
    for q in order:
        if len(out) >= k and tokens >= min_tokens:
            break
        out.append(q)
        tokens += len(q.served)
    return out


def gaps(cell, params: dict, reqs, *, tokens=None, fp8: bool = False):
    """For each request, the gaps at its served positions: the best logit
    of ``cell``'s reference minus its logit of the token at that
    position, in units of the standard deviation of the reference's
    logits there (so that configurations of other read-out scales read
    alike; ``tokens``: per request the tokens to read, default the served
    ones).  With ``fp8`` the reference itself runs as the control, and
    each position's token is the control's own first choice, read against
    nothing: the caller reads those tokens in the float32 reference."""
    seqs = [q.r.prompt + q.served[:-1] for q in reqs]
    starts = [q.plen - 1 for q in reqs]
    out = [np.zeros(len(q.served)) for q in reqs]
    firsts = [np.zeros(len(q.served), dtype=np.int64) for q in reqs]
    for i, at, logits in cell.reference.forward(
            params, cell.port, seqs, score_from=starts, fp8=fp8):
        j0 = at - starts[i]
        n = logits.shape[0]
        if fp8:
            firsts[i][j0:j0 + n] = logits.argmax(-1).cpu().numpy()
            continue
        want = (tokens[i] if tokens is not None else reqs[i].served)
        idx = torch.as_tensor(want[j0:j0 + n], device=logits.device)
        best = logits.max(-1).values
        got = logits.gather(1, idx[:, None])[:, 0]
        spread = logits.std(-1)
        out[i][j0:j0 + n] = ((best - got) / spread).cpu().numpy()
    return firsts if fp8 else out


STATS = {"logit_gap_max": np.max, "logit_gap_mean": np.mean}


def check(cell, mix, params, session, seed: int) -> dict:
    """Compare the sampled requests' gaps by every statistic the cell's
    limits file gives a limit (``logit_gap_max``, ``logit_gap_mean``:
    the widest gap and the mean gap over every compared token), and
    count the tokens compared."""
    lim = cell.limits
    reqs = sample(session, seed, int(lim["sample_requests"]), cell.port,
                  int(lim["min_tokens"]))
    g = gaps(cell, params, reqs) if reqs else []
    allg = np.concatenate(g) if g else np.zeros(0)
    checks, correct = {}, any(name in lim for name in STATS)
    for name, stat in STATS.items():
        if name not in lim:
            continue
        value = float(stat(allg)) if allg.size else float("inf")
        limit = lim[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
        correct = correct and limit is not None and value <= limit
    n_tok = int(allg.size)
    checks["tokens_compared"] = {"value": n_tok,
                                 "limit": int(lim["min_tokens"])}
    correct = correct and n_tok >= int(lim["min_tokens"])
    return {"correct": correct, "checks": checks,
            "sample": [q.r.rid for q in reqs]}
