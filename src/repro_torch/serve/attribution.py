"""Per-request latency attribution over a :class:`Tracer` timeline, from
:mod:`repro.serve.attribution`, copied: that module is framework-free,
but the port imports nothing of ``repro``.

It decomposes each request's measured TTFT and TPOT into named
components that sum **exactly** to the measured number, so "request 17
missed its TTFT target because of 2 preemption recomputes" is a query,
not a guess.  Everything here is host arithmetic over the event and span
times the tracer recorded; no scheduler state is read, so a saved trace
attributes the same as a live one.

Component taxonomy
------------------

TTFT window ``[first_token.t - ttft_s, first_token.t]`` — anchored on
the FIRST_TOKEN event's own ``ttft_s`` attribute so the parts sum to
the *measured* TTFT, not a re-derived one:

* ``queue_wait_s``     — time not covered by any admitted interval
  (queued behind admission, or re-queued by a preemption);
* ``prefill_compute_s`` — overlap with join spans of rounds where this
  request took a PREFILL_CHUNK (its own prompt being computed);
* ``preempt_recompute_s`` — the same, for chunks flagged ``recompute``
  (KV being rebuilt after a preemption — pure waste, the paper's
  recompute tax);
* ``chunk_stall_s``    — admitted time spent in *neither* of the above:
  waiting between chunks while other slots decode, other slots' joins,
  collect/host bookkeeping.

TPOT window ``[first_token.t, first_token.t + tpot_s * (tokens - 1)]``
(the RETIRE event carries ``tpot_s``):

* ``decode_segment_s`` — overlap with decode-segment spans while
  admitted (the device actually advancing this slot);
* ``verify_overhead_s`` — the slice of decode time spent computing
  speculative drafts that were *not* committed (from the request's
  SPEC_COMMIT events: ``1 - committed / (proposed + 1)`` of its verify
  work), split out of ``decode_segment_s``;
* ``preempt_recompute_s`` — join-span overlap for recompute chunks
  (a mid-decode preemption re-prefills inside the TPOT window);
* ``requeue_s``        — queued time inside the window (only preempted
  requests have any);
* ``host_sync_s``      — the admitted remainder: joins for *other*
  slots, collect, scheduling bookkeeping between segments.

Both decompositions are exact partitions of their windows — the
``check()`` method asserts the
components sum to the measured TTFT/TPOT within float tolerance.
"""
from __future__ import annotations

import dataclasses

from .telemetry import Tracer

TTFT_COMPONENTS = ("queue_wait_s", "prefill_compute_s",
                   "preempt_recompute_s", "chunk_stall_s")
TPOT_COMPONENTS = ("decode_segment_s", "verify_overhead_s",
                   "preempt_recompute_s", "requeue_s", "host_sync_s")


def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def _admitted_intervals(tl: list[dict], t_end: float) -> list[tuple]:
    """[(t0, t1)] intervals during which the request held a slot, from
    its event state machine: ADMIT opens, PREEMPT/RETIRE/CANCEL closes
    (an interval still open at ``t_end`` is clipped there).  CANCEL is
    terminal like RETIRE — a mid-flight cancellation ends the admitted
    interval at the instant its pages were released, so a cancelled
    request's TTFT decomposition partitions exactly like a retired
    one's."""
    out: list[tuple[float, float]] = []
    open_t: float | None = None
    for e in tl:
        if e["kind"] == "ADMIT" and open_t is None:
            open_t = e["t"]
        elif (e["kind"] in ("PREEMPT", "RETIRE", "CANCEL")
                and open_t is not None):
            out.append((open_t, e["t"]))
            open_t = None
    if open_t is not None:
        out.append((open_t, t_end))
    return out


def _spans_by_round(tracer: Tracer, name: str) -> dict[int, list[tuple]]:
    by: dict[int, list[tuple[float, float]]] = {}
    for sp in tracer.spans:
        if sp["name"] == name:
            by.setdefault(sp["round"], []).append((sp["t0"], sp["t1"]))
    return by


def _clipped_overlap(spans: list[tuple], admitted: list[tuple],
                     w0: float, w1: float) -> float:
    """Seconds covered by ``spans`` while admitted, inside the window —
    the triple intersection keeps every component <= the admitted total,
    so the residual terms can never go negative."""
    total = 0.0
    for s0, s1 in spans:
        for a0, a1 in admitted:
            total += _overlap(max(s0, a0), min(s1, a1), w0, w1)
    return total


@dataclasses.dataclass
class RequestAttribution:
    """One request's measured latencies and their exact decompositions.

    ``ttft[c]`` for c in :data:`TTFT_COMPONENTS` sums to ``ttft_s``;
    ``tpot[c]`` for c in :data:`TPOT_COMPONENTS` sums to
    ``tpot_s * (tokens - 1)`` (the request's total decode wall time).
    """

    rid: int
    ttft_s: float
    tpot_s: float
    tokens: int
    preemptions: int
    ttft: dict
    tpot: dict
    # terminal cancellation (None = retired normally): the reason code
    # from the CANCEL event, so a report can split "slow" from "shed"
    cancelled: str | None = None

    @property
    def decode_s(self) -> float:
        return self.tpot_s * max(0, self.tokens - 1)

    def dominant_ttft(self) -> str:
        return max(self.ttft, key=lambda k: self.ttft[k])

    def check(self, tol: float = 1e-6) -> None:
        """Assert the exact-partition contract (used by the tests)."""
        s = sum(self.ttft.values())
        if abs(s - self.ttft_s) > tol * max(1.0, self.ttft_s):
            raise AssertionError(
                f"rid {self.rid}: TTFT components sum {s} != {self.ttft_s}")
        s = sum(self.tpot.values())
        if abs(s - self.decode_s) > tol * max(1.0, self.decode_s):
            raise AssertionError(
                f"rid {self.rid}: TPOT components sum {s} != "
                f"{self.decode_s}")


def explain(tracer: Tracer, rid: int) -> RequestAttribution | None:
    """Decompose one request's TTFT/TPOT from its trace timeline.

    Returns None when the request never produced a first token (still
    in flight, or the trace predates it).  Requires a full tracer (the
    flight recorder's ring has no spans to attribute against).
    """
    tl = tracer.timeline(rid)
    first = next((e for e in tl if e["kind"] == "FIRST_TOKEN"), None)
    if first is None:
        return None
    retire = next((e for e in reversed(tl) if e["kind"] == "RETIRE"), None)
    t_end = tl[-1]["t"]
    admitted = _admitted_intervals(tl, t_end)
    joins = _spans_by_round(tracer, "join")
    segs = _spans_by_round(tracer, "decode-segment")
    chunks = [(e["round"], bool(e.get("recompute", False)))
              for e in tl if e["kind"] == "PREFILL_CHUNK"]

    # ---- TTFT: [t_ft - ttft_s, t_ft], anchored on the measured value
    ttft_s = float(first.get("ttft_s", 0.0))
    w1 = first["t"]
    w0 = w1 - ttft_s
    admitted_s = sum(_overlap(a0, a1, w0, w1) for a0, a1 in admitted)
    prefill_s = recompute_s = 0.0
    for rnd, rec in chunks:
        o = _clipped_overlap(joins.get(rnd, []), admitted, w0, w1)
        if rec:
            recompute_s += o
        else:
            prefill_s += o
    ttft = {"queue_wait_s": ttft_s - admitted_s,
            "prefill_compute_s": prefill_s,
            "preempt_recompute_s": recompute_s,
            "chunk_stall_s": admitted_s - prefill_s - recompute_s}

    # ---- TPOT: [t_ft, t_ft + tpot_s * (tokens - 1)]
    tokens = int(retire["tokens"]) if retire is not None else 0
    tpot_s = float(retire.get("tpot_s", 0.0)) if retire is not None else 0.0
    tpot = {c: 0.0 for c in TPOT_COMPONENTS}
    if tpot_s > 0.0 and tokens > 1:
        d0 = first["t"]
        d1 = d0 + tpot_s * (tokens - 1)
        adm_s = sum(_overlap(a0, a1, d0, d1) for a0, a1 in admitted)
        seg_s = _clipped_overlap(
            [iv for ivs in segs.values() for iv in ivs], admitted, d0, d1)
        rec_s = 0.0
        for rnd, rec in chunks:
            if rec:
                rec_s += _clipped_overlap(joins.get(rnd, []), admitted,
                                          d0, d1)
        # speculative waste: the fraction of verify rows (k drafts + 1
        # bonus per step) that did not commit — carved out of the
        # decode-segment overlap, since the verify *is* the decode step
        commits = [e for e in tl if e["kind"] == "SPEC_COMMIT"]
        waste = 0.0
        rows = sum(int(e.get("proposed", 0)) + 1 for e in commits)
        if rows:
            waste = 1.0 - (sum(int(e["committed"]) for e in commits)
                           / rows)
        verify_s = seg_s * waste
        tpot = {"decode_segment_s": seg_s - verify_s,
                "verify_overhead_s": verify_s,
                "preempt_recompute_s": rec_s,
                "requeue_s": (d1 - d0) - adm_s,
                "host_sync_s": adm_s - seg_s - rec_s}

    cancel = next((e for e in reversed(tl) if e["kind"] == "CANCEL"), None)
    return RequestAttribution(
        rid=rid, ttft_s=ttft_s, tpot_s=tpot_s, tokens=tokens,
        preemptions=sum(1 for e in tl if e["kind"] == "PREEMPT"),
        ttft=ttft, tpot=tpot,
        cancelled=(cancel.get("reason", "client")
                   if cancel is not None else None))


def attribution_report(tracer: Tracer) -> dict:
    """Wave-level roll-up: per-component totals/means/shares across every
    attributable request, ranked so the dominant bottleneck is the first
    thing a reader (or the bench row writer) sees."""
    reqs = [a for a in (explain(tracer, rid) for rid in tracer.rids()
            ) if a is not None]
    report: dict = {"requests": len(reqs),
                    "ttft": {}, "tpot": {},
                    "dominant_ttft_component": None,
                    "dominant_tpot_component": None,
                    "per_request": []}
    if not reqs:
        return report
    for section, comps, total_of in (
            ("ttft", TTFT_COMPONENTS, lambda a: a.ttft_s),
            ("tpot", TPOT_COMPONENTS, lambda a: a.decode_s)):
        grand = sum(total_of(a) for a in reqs)
        for c in comps:
            tot = sum(getattr(a, section)[c] for a in reqs)
            report[section][c] = {
                "total_s": tot,
                "mean_s": tot / len(reqs),
                "share": tot / grand if grand else 0.0}
        ranked = sorted(report[section],
                        key=lambda c: -report[section][c]["total_s"])
        report[f"dominant_{section}_component"] = ranked[0]
    for a in sorted(reqs, key=lambda a: -a.ttft_s):
        report["per_request"].append({
            "rid": a.rid, "ttft_s": a.ttft_s, "tpot_s": a.tpot_s,
            "tokens": a.tokens, "preemptions": a.preemptions,
            "cancelled": a.cancelled,
            "dominant_ttft": a.dominant_ttft(),
            "ttft": dict(a.ttft), "tpot": dict(a.tpot)})
    return report
