"""Serving driver of the port: continuous batching through the decode
loop (see :mod:`repro_torch.serve.scheduler`), from
:mod:`repro.launch.serve`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --requests 16 --max-new 64 --batch 8 --max-len 1024 [--paged]

Serves from dense per-slot KV stripes by default, as the JAX driver does;
``--paged`` serves from the paged pool.  Runs the full-width model on the
GPU by default; ``--reduced`` selects the smoke-scale config and
``--device cpu`` the plain PyTorch path.  Weights are random, from
``--seed``.  On the GPU each decode segment replays one CUDA graph per
bucket (captured during the first wave); ``--eager`` runs the decode loop
kernel by kernel instead.  The requests are served twice: a first wave
(capture included) and, after ``reset_stats``, a warm wave of the same
prompts into the warm batcher; both waves' tok/s are printed, with the
warm wave's latencies.

The paged pool's serving features, as in ``repro.launch.serve``:
``--prefix-cache`` (with ``--shared-prefix N``, a seeded system prompt of
N tokens before every request's own), ``--prefill-chunk`` and
``--prefill-round-tokens``, ``--speculate K`` (with
``--speculate-ngram``), and ``--optimistic`` (admission on the prompt's
pages, on-demand growth, preemption with recompute on resume; size the
pool with ``--total-pages`` below the worst case for it to preempt).  Each
``[serve]`` line then adds its wave's hit rate and skipped prefill tokens,
chunk continuations, longest join and deferrals, acceptance and tokens a
verify step, and preemptions and recomputed tokens.  With the prefix
cache on, the warm wave of the same prompts finds every full prompt page
cached, so it prefills far less than the first wave.

Overload protection and tracing, as in ``repro.launch.serve``:
``--ttft-slo`` / ``--tpot-slo`` set the SLO monitor's targets (each wave
prints its attainment and burn rates), ``--overload`` arms the
degradation controller, ``--deadline-s`` / ``--timeout-s`` stamp every
request, ``--watchdog-rounds`` bounds the rounds without progress, and
``--trace-out PATH`` records both waves' lifecycle trace, prints the
dominant TTFT component of the latency attribution and writes the
Perfetto JSON to PATH.  With any of them, each wave prints its
cancellations by reason, sheds, deadline attainment, controller state
and watchdog trips.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --reduced --device cpu --dtype float32 --paged --overload \\
      --ttft-slo 0.5 --deadline-s 30 --trace-out /tmp/trace.json

Attention routing, as in ``repro.launch.serve``: ``--attn-mode
{auto,kernel,plain}`` (``plain`` is JAX's ``xla``: gather, then plain
PyTorch attention; ``kernel`` raises on the CPU).  ``--attn-telemetry``
turns on the paged-attention ops' telemetry (:func:`repro_torch.kernels.
paged_attn.attn_telemetry`) and prints, for each wave, one ``[attn]``
line per ``(op, route)``: calls, calls made during graph capture, query
tokens, eager wall time, achieved GB/s and op/byte, then the paper's
amenability verdict of each op's measured mix.  A replayed graph does not
pass through Python, so with graphs only the eager calls and the
captures are counted; use ``--eager`` to count every call.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ArchConfig
from ..device import resolve_device
from ..kernels.paged_attn import amenability_reports, attn_telemetry
from ..models.init import cast_for_serving
from ..models.model_zoo import Model
from ..serve.attribution import attribution_report
from ..serve.engine import ServeConfig
from ..serve.scheduler import Batcher

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def run(arch: str | ArchConfig, *, reduced: bool = False, requests: int = 4,
        max_new: int = 8, batch: int = 4, max_len: int = 64, seed: int = 0,
        sync_every: int = 8, temperature: float = 0.0,
        eos_id: int | None = None, paged: bool = False, page_size: int = 16,
        total_pages: int | None = None, prompt_len: tuple[int, int] = (4, 12),
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda", params=None,
        graphs: bool | None = None, prefix_cache: bool = False,
        shared_prefix: int = 0, prefill_chunk: int | None = None,
        prefill_round_tokens: int | None = None,
        speculate_k: int | None = None, speculate_ngram: int = 2,
        optimistic: bool = False, chaos=None, trace_out: str | None = None,
        telemetry: bool = False, ttft_slo: float | None = None,
        tpot_slo: float | None = None, overload: bool = False,
        deadline_s: float | None = None, timeout_s: float | None = None,
        watchdog_rounds: int = 100_000, flight_path: str | None = None,
        attn_mode: str = "auto", attn_telemetry_on: bool = False,
        **overload_kw) -> dict:
    """Serve ``requests`` random prompts (lengths drawn from
    ``prompt_len`` = [lo, hi), tokens from ``seed``) from dense stripes,
    or from the paged pool with ``paged``, and print requests, tokens and
    tok/s.  ``shared_prefix`` tokens, drawn from the seed before the
    prompts, go in front of every prompt (a system prompt for
    ``prefix_cache``); ``prefill_chunk``, ``prefill_round_tokens``,
    ``speculate_k`` and ``speculate_ngram`` go to ``ServeConfig``, and
    ``optimistic`` sets its ``admission_mode``; ``chaos`` (a
    :class:`~repro_torch.serve.chaos.ChaosInjector`) goes to the batcher.
    ``ttft_slo``, ``tpot_slo``, ``overload``, ``watchdog_rounds``,
    ``flight_path`` and ``overload_kw`` (``overload_*`` fields) go to
    ``ServeConfig``; ``telemetry`` (or ``trace_out``) traces both waves,
    and ``trace_out`` names the Perfetto file to write; ``deadline_s``
    and ``timeout_s`` go to every ``submit``.  ``attn_mode`` goes to
    ``ServeConfig``; ``attn_telemetry_on`` records the paged-attention
    ops' telemetry for each wave (returned as ``attn``/``warm_attn``,
    the snapshot and the amenability verdicts) and prints its ``[attn]``
    lines.
    ``arch`` is a registry name or a config (one cut in depth, say).
    ``params`` (from the port's init or the bridge) replaces the
    seeded random weights when given; it is cast for serving in
    ``dtype``.  ``graphs`` goes to the batcher (None: CUDA graphs on the
    card, eager on the CPU).  The same prompts are then served a second
    time into the warm batcher, after ``reset_stats``.

    Returns the first wave's ``results`` and ``tok_per_s`` (capture
    included), the warm wave's ``warm_results``, ``warm_tok_per_s``,
    ``latency`` (``latency_stats``) and ``join`` (``join_stats``, with
    its chunk fields), and ``capture_s`` and ``graph_count``; ``joins``,
    ``segments`` and ``spec_segments`` (those that ran the verify loop)
    count both waves.  ``prefix``, ``spec``,
    ``first_join``, ``first_latency`` and ``first_segments`` are the
    first wave's ``prefix_stats``, ``spec_stats``, ``join_stats``,
    ``latency_stats`` and decode segments, ``warm_prefix``,
    ``warm_spec`` and ``warm_seconds`` the warm wave's.  ``preempt`` and
    ``warm_preempt`` are each wave's ``preempt_stats`` without its
    events, ``kv_util`` and ``warm_kv_util`` each wave's
    ``kv_utilization``, and ``pool`` the batcher's page pool (None,
    dense).  ``overload``/``warm_overload``, ``slo``/``warm_slo`` and
    ``cancelled``/``warm_cancelled`` are each wave's ``overload_stats``,
    ``slo_stats`` and cancelled requests (rid as submitted: the warm
    wave's rids follow the first wave's); ``results`` and
    ``warm_results`` hold the requests that completed, and
    ``all_results`` every result the batcher holds (a chaos burst's
    included).  ``tracer``
    is the batcher's tracer (None untraced) and ``attribution`` its
    ``attribution_report`` over both waves."""
    dev = resolve_device(device)
    tel = attn_telemetry()
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = Model(cfg)
    if params is None:
        # built in the serving dtype: the full-width MoE tree fits the card
        # only so (the float32 leaves of cast_for_serving stay float32)
        params = model.init(seed, device=dev, dtype=dtype)
    params = cast_for_serving(params, dtype)
    scfg = ServeConfig(max_len=max_len, batch=batch, dtype=dtype,
                       sync_every=sync_every, temperature=temperature,
                       attn_mode=attn_mode, paged=paged, page_size=page_size,
                       total_pages=total_pages, prefix_cache=prefix_cache,
                       prefill_chunk=prefill_chunk,
                       prefill_round_tokens=prefill_round_tokens,
                       speculate_k=speculate_k,
                       speculate_ngram=speculate_ngram,
                       admission_mode="optimistic" if optimistic
                       else "reserve",
                       telemetry=telemetry or bool(trace_out),
                       ttft_slo_s=ttft_slo, tpot_slo_s=tpot_slo,
                       overload=overload, watchdog_rounds=watchdog_rounds,
                       flight_path=flight_path, **overload_kw)
    b = Batcher(model, params, scfg, eos_id=eos_id, seed=seed,
                graphs=graphs, chaos=chaos)
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab, size=shared_prefix).tolist()
    prompts = {}
    for rid in range(requests):
        n = int(rng.integers(prompt_len[0], prompt_len[1]))
        prompts[rid] = system + rng.integers(0, cfg.vocab, size=n).tolist()

    def wave(first_rid: int) -> tuple[dict, float]:
        if attn_telemetry_on:
            tel.reset()
            tel.enable()
        for rid, p in prompts.items():
            b.submit(first_rid + rid, p, deadline_s=deadline_s,
                     timeout_s=timeout_s)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        b.run(max_new=max_new)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if attn_telemetry_on:
            tel.disable()
        return {rid: b.results[first_rid + rid] for rid in prompts
                if first_rid + rid in b.results}, dt

    results, dt = wave(0)
    toks = sum(len(v) for v in results.values())
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    layout = (f"paged pool {b.pool.n_pages}x{b.pool.page_size}" if paged
              else f"dense stripes {batch}x{max_len}")
    mode = (f"{b.graph_count} CUDA graphs, {b.capture_seconds:.3f}s "
            "capturing" if b.graphs else "eager")
    first = {"prefix": b.prefix_stats(), "spec": b.spec_stats(),
             "first_join": b.join_stats(),
             "first_latency": b.latency_stats(),
             "first_segments": b.segments, "preempt": _preempt(b),
             "kv_util": b.kv_utilization(), "overload": b.overload_stats(),
             "slo": b.slo_stats(), "cancelled": dict(b.cancelled)}
    print(f"[serve] {len(results)} requests, {toks} tokens in {dt:.3f}s "
          f"({toks / dt:.1f} tok/s on {where}, {cfg.name}, {layout}"
          f"{_features(b)}, {b.joins} joins, {b.segments} decode segments, "
          f"{mode})")
    watched = (overload or deadline_s is not None or timeout_s is not None)
    _overload_lines(b, "first wave", watched)
    first["attn"] = _attn_lines("first wave") if attn_telemetry_on else None
    b.reset_stats()
    warm_results, warm_dt = wave(requests)
    lat, join = b.latency_stats(), b.join_stats()
    warm_toks = sum(len(v) for v in warm_results.values())
    print(f"[serve] warm wave: {warm_toks} tokens in {warm_dt:.3f}s "
          f"({warm_toks / warm_dt:.1f} tok/s{_features(b)}); TTFT p50 "
          f"{lat['ttft_p50_s'] * 1e3:.1f} ms, p95 "
          f"{lat['ttft_p95_s'] * 1e3:.1f} ms; TPOT p50 "
          f"{lat['tpot_p50_s'] * 1e3:.2f} ms; {join['joins']} joins, "
          f"mean {join['mean_join_s'] * 1e3:.1f} ms")
    _overload_lines(b, "warm wave", watched)
    warm_attn = _attn_lines("warm wave") if attn_telemetry_on else None
    attribution = None
    if b.telemetry is not None:
        attribution = attribution_report(b.telemetry)
        if attribution["requests"]:
            dom = attribution["dominant_ttft_component"]
            print(f"[serve] dominant TTFT component: {dom} "
                  f"({attribution['ttft'][dom]['share']:.0%} of total TTFT "
                  f"across {attribution['requests']} requests of both "
                  "waves)")
        if trace_out:
            b.telemetry.to_perfetto(trace_out)
            print(f"[serve] wrote Perfetto trace -> {trace_out} "
                  f"({len(b.telemetry.events)} events; open at "
                  "ui.perfetto.dev)")
    return {"results": results, "prompts": prompts, "tokens": toks,
            "seconds": dt, "tok_per_s": toks / dt,
            "warm_results": warm_results,
            "warm_tok_per_s": warm_toks / warm_dt, "warm_seconds": warm_dt,
            "latency": lat,
            "join": join, "graphs": b.graphs, "joins": b.joins,
            "segments": b.segments, "spec_segments": b.spec_segments,
            "capture_s": b.capture_seconds,
            "graph_count": b.graph_count, **first,
            "warm_prefix": b.prefix_stats(), "warm_spec": b.spec_stats(),
            "warm_preempt": _preempt(b), "warm_kv_util": b.kv_utilization(),
            "warm_overload": b.overload_stats(), "warm_slo": b.slo_stats(),
            "warm_cancelled": dict(b.cancelled),
            "all_results": dict(b.results), "tracer": b.telemetry,
            "attribution": attribution, "pool": b.pool,
            "warm_attn": warm_attn}


def _attn_lines(wave: str) -> dict:
    """Print the wave's ``[attn]`` lines from the attention telemetry:
    one per ``(op, route)``, then each op's amenability verdict.  Returns
    ``{"stats": snapshot, "verdicts": {op: verdict}}``."""
    snap = attn_telemetry().snapshot()
    for key, row in snap.items():
        print(f"[attn] {wave}: {key}: {row['calls']} calls "
              f"({row['traced_calls']} captured), {row['tokens']} tokens, "
              f"wall {row['wall_s'] * 1e3:.2f} ms, "
              f"{row['achieved_gbps']:.1f} GB/s achieved, op/byte "
              f"{row['op_byte']:.2f}")
    reports = amenability_reports()
    for op, rep in reports.items():
        passed = ", ".join(c.name for c in rep.characteristics if c.passed)
        print(f"[attn] {wave}: {op}: PIM-amenability {rep.verdict.value} "
              f"(op/byte {rep.profile.op_byte:.2f}; passes: {passed})")
    return {"stats": snap,
            "verdicts": {op: r.verdict.value for op, r in reports.items()}}


def _overload_lines(b: Batcher, wave: str, watched: bool) -> None:
    """The wave's SLO line (with an SLO set) and overload line (with the
    controller, deadlines or any cancellation), in
    ``repro.launch.serve``'s words."""
    slo = b.slo_stats()
    if slo["enabled"]:
        ttft, tpot = (f"<={v:.4g}s" if v is not None else " off"
                      for v in (slo["ttft_slo_s"], slo["tpot_slo_s"]))
        print(f"[serve] {wave}: SLO attainment {slo['slo_attainment']:.0%} "
              f"(ttft{ttft}, tpot{tpot}; "
              f"burn rate ttft {slo['burn_rate_ttft']:.2f} / tpot "
              f"{slo['burn_rate_tpot']:.2f} over the last "
              f"{slo['window']} samples)")
    ost = b.overload_stats()
    if watched or ost["cancellations"] or ost["watchdog_trips"]:
        ctl = ost["controller"]
        by = ", ".join(f"{r}={n}" for r, n
                       in ost["cancelled_by_reason"].items() if n)
        print(f"[serve] {wave}: overload: {ost['cancellations']} cancelled "
              f"({by or 'none'}), {ost['shed_requests']} shed, deadline "
              f"attainment {ost['deadline_attainment']:.0%} "
              f"({ost['deadline_met']}/{ost['deadline_total']}), "
              f"controller {ctl['state']} ({len(ctl['transitions'])} "
              f"transitions), watchdog trips {ost['watchdog_trips']}")


def _preempt(b: Batcher) -> dict:
    """``preempt_stats`` without its events list."""
    return {k: v for k, v in b.preempt_stats().items() if k != "events"}


def _features(b: Batcher) -> str:
    """The ``[serve]`` line's suffixes for the serving features that are
    on, from the current wave's stats, in ``repro.launch.serve``'s words."""
    cfg, out = b.cfg, ""
    if cfg.prefill_chunk:
        j = b.join_stats()
        out += (f" + chunked prefill ({cfg.prefill_chunk} tok/chunk, "
                f"{j['chunk_joins']} continuations, max join stall "
                f"{j['max_join_s'] * 1e3:.0f}ms)")
        if cfg.prefill_round_tokens:
            out += (f" + round budget ({cfg.prefill_round_tokens} tok, "
                    f"{j['budget_deferrals']} deferrals)")
    if cfg.prefix_cache:
        p = b.prefix_stats()
        out += (f" + prefix cache (hit rate {p['hit_rate']:.0%}, "
                f"{p['prefill_skipped']} prefill tokens skipped)")
    if cfg.speculate_k:
        sp = b.spec_stats()
        out += (f" + speculative k={cfg.speculate_k} (acceptance "
                f"{sp['acceptance_rate']:.0%}, "
                f"{sp['tokens_per_step']:.2f} tok/step)")
    if cfg.admission_mode == "optimistic":
        k = b.preempt_stats()
        out += (f" + optimistic admission ({k['preemptions']} "
                f"preemptions, {k['recompute_tokens']} tokens "
                "recomputed)")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync-every", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool + per-slot page tables (default: "
                         "dense per-slot stripes)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--total-pages", type=int, default=None,
                    help="pool size in pages (default: batch * max pages)")
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 12),
                    metavar=("LO", "HI"),
                    help="prompt lengths are drawn from [LO, HI)")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--eager", action="store_true",
                    help="run the decode loop kernel by kernel on the GPU "
                         "instead of replaying one CUDA graph per bucket")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="shared-prefix radix cache over the page pool "
                         "(needs --paged): requests matching a cached "
                         "page-aligned prompt prefix share its pages and "
                         "prefill only their suffix")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="put this many shared system-prompt tokens in "
                         "front of every request (for --prefix-cache)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill (needs --paged): prefill each "
                         "prompt's uncached suffix at most this many "
                         "tokens a join round (a multiple of --page-size)")
    ap.add_argument("--prefill-round-tokens", type=int, default=None,
                    help="cap the prefill tokens (chunks and admissions) "
                         "one refill round may take, deferring the rest")
    ap.add_argument("--speculate", type=int, default=None,
                    help="self-speculative decoding (needs --paged, "
                         "greedy): draft this many tokens a step from the "
                         "slot's own history and verify them in one "
                         "multi-token paged attention call")
    ap.add_argument("--speculate-ngram", type=int, default=2,
                    help="history-match width of the draft lookup")
    ap.add_argument("--optimistic", action="store_true",
                    help="optimistic admission (needs --paged): admit on "
                         "prompt pages only, grow on demand, preempt + "
                         "recompute under pool pressure")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record both waves' request-lifecycle trace and "
                         "write it as Chrome/Perfetto trace_event JSON "
                         "(open at ui.perfetto.dev); also prints the "
                         "dominant TTFT component of the latency "
                         "attribution")
    ap.add_argument("--ttft-slo", type=float, default=None, metavar="S",
                    help="TTFT SLO in seconds: each wave reports its "
                         "per-class attainment and windowed burn rate")
    ap.add_argument("--tpot-slo", type=float, default=None, metavar="S",
                    help="per-output-token SLO in seconds (see "
                         "--ttft-slo)")
    ap.add_argument("--overload", action="store_true",
                    help="the SLO-burn/pool-pressure degradation "
                         "controller (HEALTHY -> DEGRADED -> SHEDDING "
                         "with hysteresis): sheds speculation, shrinks "
                         "prefill chunks, freezes optimistic growth, and "
                         "sheds lowest-priority queued work under "
                         "sustained overload")
    ap.add_argument("--deadline-s", type=float, default=None, metavar="S",
                    help="stamp every request with this completion "
                         "deadline; expired or unreachable requests are "
                         "cancelled and their pages reclaimed")
    ap.add_argument("--timeout-s", type=float, default=None, metavar="S",
                    help="hard per-request timeout (cancelled with reason "
                         "'timeout' when exceeded)")
    ap.add_argument("--attn-mode", default="auto",
                    choices=("auto", "kernel", "plain"),
                    help="attention route: auto (kernels on the GPU, plain "
                         "on the CPU), kernel, or plain (gather, then "
                         "plain PyTorch attention)")
    ap.add_argument("--attn-telemetry", action="store_true",
                    help="print each wave's paged-attention telemetry "
                         "([attn] lines) and amenability verdicts")
    ap.add_argument("--watchdog-rounds", type=int, default=100_000,
                    help="progress watchdog: rounds without progress "
                         "before the scheduler dumps a flight bundle and "
                         "force-sheds the blocking request")
    args = ap.parse_args()
    run(args.arch, reduced=args.reduced, requests=args.requests,
        max_new=args.max_new, batch=args.batch, max_len=args.max_len,
        seed=args.seed, sync_every=args.sync_every,
        temperature=args.temperature, eos_id=args.eos_id,
        paged=args.paged, page_size=args.page_size,
        total_pages=args.total_pages, prompt_len=tuple(args.prompt_len),
        dtype=_DTYPES[args.dtype], device=args.device,
        graphs=False if args.eager else None,
        prefix_cache=args.prefix_cache, shared_prefix=args.shared_prefix,
        prefill_chunk=args.prefill_chunk,
        prefill_round_tokens=args.prefill_round_tokens,
        speculate_k=args.speculate, speculate_ngram=args.speculate_ngram,
        optimistic=args.optimistic, trace_out=args.trace_out,
        ttft_slo=args.ttft_slo, tpot_slo=args.tpot_slo,
        overload=args.overload, deadline_s=args.deadline_s,
        timeout_s=args.timeout_s, watchdog_rounds=args.watchdog_rounds,
        attn_mode=args.attn_mode, attn_telemetry_on=args.attn_telemetry)


if __name__ == "__main__":
    main()
