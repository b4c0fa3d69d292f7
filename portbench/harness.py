"""One run of one cell: set-up, the measured window, the correctness
check and the result line.

The system under test is ``repro_torch.serve.scheduler.Batcher``, paged,
built as ``repro_torch.launch.serve.run`` builds it: pages of 16, CUDA
graphs on the card, greedy, ``sync_every`` 8, reserve admission, every
serving feature off, EOS ignored.  The benchmark drives it through its
public surface (``submit``, ``run``, ``cancel``, ``outputs``,
``results``, ``queue``, ``slot_rid``, ``join_stats``) and reads the
batcher's own first-token stamps.  The batcher has no per-round client
entry and one ``max_new`` for a whole ``run``, so the client acts through
the constructor's ``chaos=`` hook, which the batcher calls at the top of
every scheduling round: it submits arrivals when they are due, keeps a
backlog full, cancels a request (reason ``client``) once it holds its
drawn output count (tokens past it are not output) and ends the window.

Phases, in the client's order:

- ``warm``: one request a stage, one stage for every join width and
  decode bucket the mix can reach (``traffic.warm_prompt_lengths``):
  each joins, decodes one segment (the bucket's eager warm-up and graph
  capture) and is cancelled;
- ``ramp``: the mix's traffic until it is steady (a backlog: until
  ``ramp_completions`` requests have finished; an open loop: ``ramp_s``
  of arrivals);
- ``window``: ``seconds`` of the same traffic, measured;
- ``drain`` (open loop): arrivals go on until every request that arrived
  in the window has its first token (at most ``DRAIN_S`` more), so every
  time to first token is taken under the cell's load;
- ``finish`` (open loop): no more arrivals; the window's requests run to
  their drawn counts (at most ``DRAIN_S`` more) for the check;
- ``closed``: everything queued and live is cancelled.

Set-up (``setup_s``) is process start to the window's first round.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from . import check, flops, spec, trace, traffic
from .weights import make_weights

DRAIN_S = 90.0           # the most each of drain and finish waits
PROFILE_S = 3.0          # the traced stretch: this long, two rounds at least
MARK = "portbench.clock_mark"


@dataclasses.dataclass
class Req:
    r: traffic.Request
    t_arrival: float                 # scheduled (open) or submitted
    t_first: float | None = None     # the batcher's first-token stamp
    t_done: float | None = None      # the client saw its last token
    n: int = 0                       # output tokens seen
    slot: int | None = None
    warm: bool = False
    served: list[int] | None = None  # tokens served, up to the drawn count

    @property
    def plen(self) -> int:
        return len(self.r.prompt)


@dataclasses.dataclass
class Round:
    """One scheduling round as the client saw it: at its top (``t``, the
    batcher's ``round``), the rows it could decode with their output
    counts (``before``) and, filled at the next round's top, what they
    held after it (``after``)."""
    t: float
    round: int
    hook_s: float
    before: dict[int, int]
    after: dict[int, int] | None = None
    idle: bool = False


class Client:
    """The round hook handed to the batcher as ``chaos=`` (it takes the
    injector's interface: ``on_round``, ``pick_victim``, ``on_drain`` and
    ``slot_failures``, and injects nothing)."""

    slot_failures = 0

    def __init__(self, session: "Session"):
        self.session = session

    def on_round(self, b) -> None:
        self.session.tick(b)

    def pick_victim(self, b, candidates):
        return None

    def on_drain(self, b) -> None:
        pass


class Session:
    def __init__(self, mix: traffic.Mix, stream: traffic.Stream,
                 warm_stream: traffic.Stream, seconds: float,
                 profile: bool):
        self.mix, self.stream, self.warm_stream = mix, stream, warm_stream
        self.seconds = seconds
        self.reqs: dict[int, Req] = {}
        self.active: dict[int, Req] = {}
        self.rounds: list[Round] = []
        self.phase = "warm"
        self.warm_lengths = traffic.warm_prompt_lengths(mix)
        self.warm_rid: int | None = None
        self.next_warm_rid = -1
        self.t_ramp0: float | None = None
        self.w0: float | None = None
        self.w1: float | None = None
        self.t_finish: float | None = None
        self.completed = 0
        self.pending: traffic.Request | None = None
        self.profile = profile
        self.prof = None
        self.prof_t0 = self.prof_t1 = self.prof_mark = None
        self.join0 = self.join1 = None
        self.n_w0: dict[int, int] = {}
        self.n_w1: dict[int, int] = {}
        self.prof_rounds = [0, 0]
        self.late_s: list[float] = []

    # -- the client's view of the batcher -------------------------------
    def _observe(self, b, now: float) -> dict[int, int]:
        slots = {rid: i for i, rid in enumerate(b.slot_rid)
                 if rid is not None}
        seen = {}
        for rid, q in list(self.active.items()):
            out = b.outputs.get(rid)
            n = len(out) if out is not None else 0
            seen[rid] = n
            if n and q.t_first is None:
                q.t_first = b._first_tok_t.get(rid, now)
            if q.slot is None and rid in slots:
                q.slot = slots[rid]
            q.n = n
            if q.warm:
                if n >= 1 + self.mix.sync_every:
                    b.cancel(rid, "client")
                    del self.active[rid]
                    self.warm_rid = None
                continue
            if n >= q.r.out_len:
                q.t_done = now
                q.served = list(out[:q.r.out_len])
                self.completed += 1
                if rid not in b.results:
                    b.cancel(rid, "client")
                del self.active[rid]
        if self.rounds and self.rounds[-1].after is None:
            self.rounds[-1].after = seen
        return seen

    def _submit(self, b, r: traffic.Request, t_arrival: float,
                warm: bool = False) -> None:
        q = Req(r, t_arrival, warm=warm)
        self.reqs[r.rid] = q
        self.active[r.rid] = q
        b.submit(r.rid, r.prompt)

    def _due(self, b, now: float) -> None:
        """Submit the open loop's arrivals scheduled by ``now``."""
        while True:
            if self.pending is None:
                self.pending = self.stream.next()
            t = self.t_ramp0 + self.pending.arrival
            if t > now:
                return
            self.late_s.append(now - t)
            self._submit(b, self.pending, t)
            self.pending = None

    def next_event(self) -> float | None:
        """When an idle batcher next needs the client: the next arrival
        of an open loop, the window's end, or now (set-up, a drain); None
        for now."""
        if self.phase in ("warm", "drain", "finish", "close") \
                or self.t_ramp0 is None:
            return None
        if self.mix.kind != "open":
            return None
        if self.pending is None:
            self.pending = self.stream.next()
        t = self.t_ramp0 + self.pending.arrival
        if self.phase == "ramp":
            t = min(t, self.t_ramp0 + self.mix.ramp_s)
        if self.phase == "window":
            t = min(t, self.w0 + self.seconds)
        return t

    def _top_up(self, b, now: float) -> None:
        while len(b.queue) < self.mix.queue_depth:
            self._submit(b, self.stream.next(), now)

    def _close(self, b) -> None:
        for rid, q in self.active.items():
            out = b.outputs.get(rid) or []
            if not q.warm and len(out) >= 2:
                # served so far: the check may read an in-flight request
                q.served = list(out[:min(len(out), q.r.out_len)])
        for rid, _ in list(b.queue):
            b.cancel(rid, "client")
        for rid in list(b.slot_rid):
            if rid is not None:
                b.cancel(rid, "client")
        self.active.clear()
        self.phase = "closed"

    # -- one round's top ----------------------------------------------
    def tick(self, b, idle: bool = False) -> None:
        t0 = time.perf_counter()
        self._observe(b, t0)
        if self.phase == "warm":
            if self.warm_rid is None:
                if self.warm_lengths:
                    p = self.warm_lengths.pop(0)
                    r = self.warm_stream.next()
                    r = traffic.Request(self.next_warm_rid,
                                        (r.prompt * (p // len(r.prompt)
                                                     + 1))[:p],
                                        self.mix.max_new)
                    self.next_warm_rid -= 1
                    self.warm_rid = r.rid
                    self._submit(b, r, t0, warm=True)
                else:
                    self.phase = "ramp"
                    self.t_ramp0 = t0
                    if self.mix.kind == "backlog":
                        for _ in range(self.mix.slots):
                            self._submit(b, self.stream.next(), t0)
        if self.phase == "ramp":
            if self.mix.kind == "open":
                if t0 >= self.t_ramp0 + self.mix.ramp_s:
                    self._open_window(b, t0)
            elif self.completed >= (self.mix.ramp_completions
                                    or self.mix.slots // 2):
                self._open_window(b, t0)
        if self.phase == "window" and t0 >= self.w0 + self.seconds:
            self.w1 = t0
            self.join1 = b.join_stats()
            self.n_w1 = self._counts()
            if self.prof is not None:
                self._stop_profile()
            self.phase = "drain" if self.mix.kind == "open" else "close"
        if self.phase == "window" and self.profile:
            self._profile_step(t0)
        if self.phase in ("drain", "finish"):
            mine = [q for q in self.reqs.values()
                    if not q.warm and self.w0 <= q.t_arrival < self.w1]
            if self.phase == "drain" and (
                    all(q.t_first is not None for q in mine)
                    or t0 >= self.w1 + DRAIN_S):
                self.phase, self.t_finish = "finish", t0
            if self.phase == "finish" and (
                    all(q.t_done is not None for q in mine)
                    or t0 >= self.t_finish + DRAIN_S):
                self.phase = "close"
        if self.phase == "close":
            self._close(b)
        elif self.phase in ("ramp", "window", "drain"):
            if self.mix.kind == "open":
                self._due(b, t0)
            else:
                self._top_up(b, t0)
        before = {rid: q.n for rid, q in self.active.items()}
        t1 = time.perf_counter()
        self.rounds.append(Round(t0, b.round, t1 - t0, before, idle=idle))

    def _open_window(self, b, now: float) -> None:
        self.phase = "window"
        self.w0 = now
        self.join0 = b.join_stats()
        self.n_w0 = self._counts()

    def _counts(self) -> dict[int, int]:
        """Each request's output tokens so far, capped at its drawn
        count."""
        return {rid: min(q.n, q.r.out_len) for rid, q in self.reqs.items()
                if not q.warm}

    def _profile_step(self, now: float) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        start = self.w0 + 0.3 * self.seconds
        if self.prof is None and self.prof_t0 is None and now >= start:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.prof_t0 = time.perf_counter()
            self.prof_rounds[0] = len(self.rounds)
            with record_function(MARK):
                pass
            self.prof_mark = self.prof_t0
        elif self.prof is not None and self.prof_t1 is None:
            span = min(PROFILE_S, 0.3 * self.seconds)
            n_rounds = sum(1 for r in self.rounds if r.t >= self.prof_t0)
            if now >= self.prof_t0 + span and n_rounds >= 2:
                self._stop_profile()

    def _stop_profile(self) -> None:
        if self.prof_t1 is None:
            torch.cuda.synchronize()
            self.prof_t1 = time.perf_counter()
            self.prof_rounds[1] = len(self.rounds)
            self.prof.stop()

    # -- after the run -------------------------------------------------
    def window_reqs(self) -> list[Req]:
        return [q for q in self.reqs.values() if not q.warm]


@dataclasses.dataclass
class Run:
    """What a metric reader gets."""
    cell: spec.Cell
    mix: traffic.Mix
    shapes: flops.Shapes
    session: Session
    setup_s: float
    setup_parts: dict = dataclasses.field(default_factory=dict)
    spans: list = dataclasses.field(default_factory=list)
    stretch: trace.Stretch | None = None

    @property
    def w0(self) -> float:
        return self.session.w0

    @property
    def w1(self) -> float:
        return self.session.w1

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def window_rounds(self, t0: float | None = None,
                      t1: float | None = None) -> list[Round]:
        """The rounds whose top lies in [t0, t1) (default: the window),
        with their ``after`` filled."""
        t0 = self.w0 if t0 is None else t0
        t1 = self.w1 if t1 is None else t1
        return [r for r in self.session.rounds
                if t0 <= r.t < t1 and r.after is not None and not r.idle]

    def model_flops(self) -> float:
        """Model operations of every prompt and output token the device
        processed in the window's rounds (``flops``)."""
        work = 0.0
        for rnd in self.window_rounds():
            joined, steps = self.round_work(rnd)
            work += sum(flops.prompt_flops(self.shapes, n) for n in joined)
            work += sum(flops.decode_flops(self.shapes, k)
                        for step in steps for k in step)
        return work

    def stretch_rounds(self) -> list[Round]:
        """The rounds whose whole body the profiler traced."""
        a, b = self.session.prof_rounds
        return [r for r in self.session.rounds[a:b] if r.after is not None]

    def round_work(self, rnd: Round):
        """(joined prompt lengths, per decode step the keys each live row
        read) of one round, from the client's counts."""
        reqs = self.session.reqs
        joined: list[int] = []
        steps: list[list[int]] = [[] for _ in range(self.mix.sync_every)]
        for rid, nb in rnd.before.items():
            na = rnd.after.get(rid, nb)
            if na <= nb:
                continue
            q = reqs[rid]
            joins = nb == 0
            if joins:
                joined.append(q.plen)
            m0 = 1 if joins else nb
            for j in range(min(na - nb - joins, len(steps))):
                steps[j].append(q.plen + m0 + j)
        return joined, [s for s in steps if s]


def run_cell(cell: spec.Cell, *, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float,
             dtype: torch.dtype = torch.bfloat16,
             mix: traffic.Mix | None = None, check_fn=None) -> dict:
    """One run; returns the result dict (the line to print) and, under
    ``"_run"``, the :class:`Run` for the caller's diagnostics."""
    from repro_torch.models.model_zoo import Model
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import Batcher

    marks = {"imports": time.perf_counter()}
    port = cell.port
    mix = mix or traffic.Mix.load(spec.traffic_path(cell.traffic))
    arch = spec.arch(cell.config_name, port)
    model = Model(arch)
    params = make_weights(model.abstract_ptree(), seed, device, dtype)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks["weights"] = time.perf_counter()
    scfg = ServeConfig(max_len=mix.max_len, batch=mix.slots, dtype=dtype,
                       sync_every=mix.sync_every, temperature=0.0,
                       paged=True, page_size=mix.page_size,
                       total_pages=mix.total_pages, telemetry=traced)
    stream = traffic.Stream(mix, seed, port["vocab"])
    warm_stream = traffic.Stream(mix, seed + 1, port["vocab"])
    session = Session(mix, stream, warm_stream, seconds, traced
                      and device.type == "cuda")
    b = Batcher(model, params, scfg, eos_id=None, seed=seed,
                chaos=Client(session))
    marks["batcher"] = time.perf_counter()
    while session.phase != "closed":
        if b.queue or any(r is not None for r in b.slot_rid):
            b.run(max_new=mix.max_new)
            continue
        nxt = session.next_event()
        if nxt is not None:
            wait = nxt - time.perf_counter()
            if wait > 0:
                time.sleep(min(wait, 0.002))
                continue
        session.tick(b, idle=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0
    marks["warm"] = session.t_ramp0
    marks["ramp"] = session.w0
    run = Run(cell, mix, flops.Shapes.of(port), session,
              setup_s=session.w0 - t_start,
              setup_parts=_parts(t_start, marks))
    if b.telemetry is not None:
        run.spans = [(s["name"], s["round"], s["t0"], s["t1"])
                     for s in b.telemetry.spans]
    if session.prof is not None:
        run.stretch = _stretch(session, run.spans)
    # the program's state goes before the reference runs
    del b
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checked = (check_fn or check.check)(cell, mix, params, session, seed)
    del params
    gc.collect()
    result = _result(run, checked, peak, device, traced)
    result["_run"] = run
    return result


def _parts(t_start: float, marks: dict) -> dict:
    """Set-up split at its marks: seconds to each from the one before."""
    out, prev = {}, t_start
    for name, t in marks.items():
        out[name] = t - prev
        prev = t
    return out


def _stretch(session: Session, spans) -> trace.Stretch:
    prof = session.prof
    offset = trace.clock_offset(prof, MARK, session.prof_mark)
    events = trace.device_events(prof, offset or 0.0)
    t0, t1 = session.prof_t0, session.prof_t1
    host = [(name, a, b) for name, _, a, b in spans
            if b >= t0 and a <= t1]
    host += [("client hook", r.t, r.t + r.hook_s) for r in session.rounds
             if t0 <= r.t <= t1]
    events = [e for e in events if e.t1 >= t0 and e.t0 <= t1]
    return trace.Stretch(t0, t1, events, host)


def _result(run: Run, checked: dict, peak: int, device: torch.device,
            traced: bool) -> dict:
    cell = run.cell
    out_metrics = {}
    for m in (cell.metrics_layer if traced else cell.metrics_e2e):
        value = m.reader().read(run)
        if value is not None:
            out_metrics[m.name] = {"value": float(value), "unit": m.unit}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell.chips, "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": peak}
    attempted, failed = attempts(run)
    result = {"correct": bool(checked["correct"]) and failed == 0,
              "attempted": attempted, "failed": failed,
              "metrics": out_metrics, "device": dev}
    if traced and run.stretch is not None:
        dev["busy_s"] = run.stretch.busy_s()
        dev["window_s"] = run.stretch.window_s
        result["breakdown"] = {"device_ops": run.stretch.top_ops(),
                               "idle_gaps": run.stretch.idle_by_host()}
    checks = dict(checked["checks"])
    checks["requests_failed"] = {"value": failed, "limit": 0}
    result["checks"] = checks
    return result


def attempts(run: Run) -> tuple[int, int]:
    """Requests the window counts, and those of them that failed.  Open
    loop: the requests that arrived in the window; one not finished when
    the drain ended failed.  Backlog: the requests served in the window
    (finished in it, or live when it closed); none of them can fail short
    of an error, which ends the run."""
    s = run.session
    reqs = s.window_reqs()
    if run.mix.kind == "open":
        mine = [q for q in reqs if s.w0 <= q.t_arrival < s.w1]
        return len(mine), sum(q.t_done is None for q in mine)
    mine = [q for q in reqs if q.t_first is not None and q.t_first < s.w1
            and (q.t_done is None or q.t_done >= s.w0)]
    return len(mine), 0
