"""Serve tok/s and the decode wrappers' host time, or the device times of
the primitive ops, of one source tree, so that two trees (a change and
its parent) can be compared on one card.

  python src/repro_torch/launch/serve_ab.py [--src DIR] \\
      [--arch qwen2-0.5b] [--layouts paged dense] [--reps 2] [--graphs-ab]
  python src/repro_torch/launch/serve_ab.py --primitives [--src DIR] \\
      [--steps 5]
  python src/repro_torch/launch/serve_ab.py --moe-train [--src DIR] \\
      [--steps 5]
  python src/repro_torch/launch/serve_ab.py --kernel-outputs OUT.npz \\
      [--src DIR]
  python src/repro_torch/launch/serve_ab.py --compare-outputs A.npz B.npz

Imports ``repro_torch`` from ``--src``, a tree's ``src`` directory (by
default the one this file lies in), so a parent commit unpacked with
``git archive`` runs through the same measurement; run it as a file, not
with ``-m``.  The timing helpers are always this file's own tree's
(``timing.py`` beside it), whichever tree is measured.

Serve (the default): it times, at the serve cell's attention geometry in
bf16 (batch 8, slot lengths 65-576), the host time of one call of each
decode wrapper (200 calls enqueued back to back, on the host clock; the
least and the median of 7 such runs), then serves the cell of
``chip_smoke.py`` (16 requests, prompts of 64-512 tokens, 64 new tokens
each, batch 8, max_len 1024, pages of 16, 8 steps per host sync, seeded
random weights) ``--reps`` times for each layout, after one short run
that warms up.  The weights are built once.  Each serve run is a first
wave and, where the tree's ``launch.serve.run`` makes one, a warm wave of
the same prompts into the warm batcher; both waves' tok/s are kept.
Compare two trees in one machine, alternating them over several
processes: tok/s drifts with the host's speed over minutes.
``--graphs-ab`` compares, on the one tree, decode segments replayed as
CUDA graphs (the default) against the eager loop (``graphs=False``),
alternating the two within each repetition (graphs, eager, then eager,
graphs).

``--primitives``: at ``wavesim.Problem()`` (R = 1,728,000 rows of 27), in
float32 and bfloat16, the public op ``wavesim_volume.volume`` and
``torch.matmul(x, W)``; at 64 Mi float16 elements, ``vector_sum`` and
``torch.add``.  Each is timed twice: 20 calls captured in one CUDA graph
and replayed (device time, ``graph_ms``), and 20 calls enqueued back to
back between CUDA events (``ms``, which includes the host); the median of
5 replays or runs.  Then ``--steps`` wave steps at ``Problem()`` through
``launch.wave_demo.run`` (ms a step and the volume op's ms, medians).

``--moe-train``: the MoE train step of ``chip_smoke.py``'s ``[train]``
(c): full-width moonshot-v1-16b-a3b cut to 1 dense + 1 MoE layer, seeded
float32 params, bf16 activations, remat, batch 4 x L 1,024 from the
port's ``DataPipeline``; ``--steps`` + 1 steps, the median step ms on the
host clock from the second (each step ends in a read of its loss).  Then
the grouped GEMM's backward alone (``group_gemm_backward``, bf16) at a
4,096-token join's gate/up shapes (E 64, C 480, D 2048, F 1408; counts
from a seeded routing, dy float32), by CUDA events: what the two trees'
expert GEMM backwards differ by, beside the step they sit in.

``--kernel-outputs OUT.npz``: the paged decode and prefill kernels'
outputs, through their wrappers with no launch argument (the tree's
default launch), at full-width qwen2-0.5b's and moonshot's geometry in
bfloat16 and float32 on seeded inputs (decode: 8 slots, lengths 64-600;
verify: Lq 5 at depths 320-600; a join of 8 prompts of 64-512 tokens),
saved bit for bit.  ``--compare-outputs A B`` says, per output, whether
two such files (two trees' runs, in two processes: both trees' extensions
share one module name) are bit-identical, and exits 1 if one is not.

The last line is a JSON summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import statistics
import sys
import time


def own_timing():
    """``timing.py`` of this file's tree, loaded by path: ``--src`` may
    name a tree that has no such module."""
    path = pathlib.Path(__file__).resolve().with_name("timing.py")
    spec = importlib.util.spec_from_file_location("serve_ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def wrapper_host_us(torch, timing, cfg, reps: int = 7) -> dict:
    """Host us a call of ``paged_attn_cuda`` (a table of 64 pages of 16)
    and ``decode_attn_cuda`` (stripes of 1,025 rows, s_cap 1,024): the
    least and the median of ``reps`` runs of ``timing.host_us`` (a busy
    host only adds time, so the least is the wrapper's own cost)."""
    import numpy as np
    from repro_torch.kernels.decode_attn import kernel as dkernel
    from repro_torch.kernels.paged_attn import kernel as pkernel
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    b, hq, hkv, d = 8, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    bf16 = torch.bfloat16
    lengths = torch.tensor(rng.integers(65, 577, size=b), dtype=torch.int32,
                           device=dev)
    q = torch.randn(b, hq, d, device=dev).to(bf16)
    pool = torch.randn(2, 512, 16, hkv, d, device=dev).to(bf16)
    table = torch.tensor(rng.permutation(512)[:b * 64].reshape(b, 64),
                         dtype=torch.int32, device=dev)
    stripes = torch.randn(2, b, 1025, hkv, d, device=dev).to(bf16)
    calls = {
        "paged_decode": lambda i: pkernel.paged_attn_cuda(
            q, pool[0], pool[1], table, lengths),
        "decode_attn": lambda i: dkernel.decode_attn_cuda(
            q, stripes[0], stripes[1], lengths, 1024)}
    out = {}
    for name, fn in calls.items():
        runs = [timing.host_us(fn) for _ in range(reps)]
        out[name] = {"least": min(runs), "median": statistics.median(runs)}
    return out


def serve(torch, timing, args) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run
    from repro_torch.models.model_zoo import Model
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    host = wrapper_host_us(torch, timing, cfg)
    print(f"[serve_ab] {args.src}: wrapper host us a call {host}",
          flush=True)
    params = Model(cfg).init(0, device=dev, dtype=torch.bfloat16)
    modes = ((("graphs", {}), ("eager", {"graphs": False}))
             if args.graphs_ab else (("default", {}),))
    tok_s, warm_tok_s = {}, {}
    for layout in args.layouts:
        paged = layout == "paged"
        kw = dict(batch=8, max_len=1024, paged=paged, page_size=16,
                  sync_every=8, seed=0, dtype=torch.bfloat16, device=dev,
                  params=params)
        for _, extra in modes:
            run(cfg, requests=2, max_new=8, prompt_len=(64, 65), **kw,
                **extra)
        for rep in range(args.reps):
            for mode, extra in (modes if rep % 2 == 0 else modes[::-1]):
                res = run(cfg, requests=16, max_new=64,
                          prompt_len=(64, 513), **kw, **extra)
                key = f"{layout} {mode}"
                tok_s.setdefault(key, []).append(res["tok_per_s"])
                if "warm_tok_per_s" in res:
                    warm_tok_s.setdefault(key, []).append(
                        res["warm_tok_per_s"])
    return {"arch": cfg.name, "host_us": host, "tok_per_s": tok_s,
            "warm_tok_per_s": warm_tok_s}


def primitives(torch, timing, args) -> dict:
    from repro_torch.core.primitives import wavesim
    from repro_torch.kernels import vector_sum as vs
    from repro_torch.kernels import wavesim_volume as wv
    from repro_torch.launch import wave_demo

    def both(fn) -> dict:
        return {"graph_ms": timing.graph_ms(lambda i: fn(), 20),
                "ms": timing.time_ms(lambda i: fn(), 20)}
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    prob = wavesim.Problem()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.randn(prob.n_elements, prob.n_fields, 3, 3, 3,
                        generator=gen, device="cuda").to(dtype)
        x = u.view(-1, 27)
        w = wv.fused_operator(1.0, dtype).cuda()
        name = str(dtype).split(".")[1]
        out[f"volume_{name}"] = both(lambda: wv.volume(u))
        out[f"matmul_{name}"] = both(lambda: torch.matmul(x, w))
        del u, x
    n = 64 << 20
    a = torch.randn(n, generator=gen, device="cuda").to(torch.float16)
    b = torch.randn(n, generator=gen, device="cuda").to(torch.float16)
    out["vector_sum_float16"] = both(lambda: vs.vector_sum(a, b))
    out["add_float16"] = both(lambda: torch.add(a, b))
    del a, b
    res = wave_demo.run(prob.grid, prob.n_fields, args.steps,
                        wave_demo.DEMO_DT, device="cuda", seed=0,
                        verbose=False)
    out["wave_step_ms"] = statistics.median(res["step_ms"])
    out["wave_volume_ms"] = statistics.median(res["volume_ms"])
    for key, val in out.items():
        if isinstance(val, dict):
            print(f"[serve_ab] {key}: device {val['graph_ms']:.4f} ms, "
                  f"events {val['ms']:.4f} ms", flush=True)
    return out


def moe_train(torch, timing, args) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import BlockKind, Segment
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels.moe_group_gemm import group_gemm_backward
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import (TrainConfig, make_train_state,
                                              make_train_step)
    cfg = get_config("moonshot-v1-16b-a3b")
    cut = dataclasses.replace(cfg, n_layers=2, segments=(
        Segment(BlockKind.DENSE, 1), Segment(BlockKind.MOE, 1)))
    model = Model(cut)
    tcfg = TrainConfig(opt=opt.OptConfig(lr=3e-4, warmup_steps=2,
                                         total_steps=args.steps + 1))
    state = make_train_state(model, 0, tcfg, device="cuda")
    data = DataPipeline(DataConfig(vocab=cut.vocab, seq_len=1024,
                                   global_batch=4, seed=0))
    step = make_train_step(model, tcfg)
    step_ms = []
    for s in range(args.steps + 1):
        batch = {"tokens": torch.from_numpy(
            data.batch_at(s)["tokens"]).cuda()}
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    del state, step
    torch.cuda.empty_cache()
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    gen = torch.Generator(device="cuda").manual_seed(1)
    router = {"w": 0.02 * torch.randn(d, e, generator=gen, device="cuda")}
    x = torch.randn(4096, d, generator=gen, device="cuda")
    _, ids, _ = moe.route({"router": router}, x, cfg)
    c = moe.capacity(cfg, 4096)
    counts = moe.dispatch(ids, e, c)[2].to(torch.int32)
    live = torch.arange(c, device="cuda")[None, :, None] < counts[:, None,
                                                                  None]
    xe = (torch.randn(e, c, d, generator=gen, device="cuda")
          * live).to(torch.bfloat16)
    w = (torch.randn(e, d, f, generator=gen, device="cuda")
         / d ** 0.5).to(torch.bfloat16)
    dy = torch.randn(e, c, f, generator=gen, device="cuda")
    bwd_ms = timing.time_ms(lambda i: group_gemm_backward(xe, w, counts,
                                                          dy), 5)
    out = {"step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms[1:]),
           "backward_ms": bwd_ms, "live_rows": int(counts.sum())}
    print(f"[serve_ab] moe train step {out['median_step_ms']:.2f} ms "
          f"(median of steps 1-{args.steps}), group_gemm backward "
          f"{bwd_ms:.4f} ms at E {e} C {c} D {d} F {f}", flush=True)
    return out


def kernel_outputs(torch, path: str) -> dict:
    """Save the default launches' outputs (see the module docstring)."""
    import numpy as np
    from repro_torch.kernels.paged_attn import kernel
    dev = torch.device("cuda", 0)
    out = {}
    for hq, hkv, d in ((14, 2, 64), (16, 16, 128)):
        for dtype in (torch.bfloat16, torch.float32):
            rng = np.random.default_rng(hq + d)
            b, ps, p_max = 8, 16, 38
            pool = rng.standard_normal((2, b * p_max + 1, ps, hkv, d))
            k, v = (torch.from_numpy(x).to(dev).to(dtype) for x in pool)
            tbl = torch.from_numpy(rng.permutation(b * p_max).reshape(
                b, p_max).astype(np.int32)).to(dev)
            tag = f"hq{hq}.hkv{hkv}.d{d}.{str(dtype).split('.')[1]}"
            lengths = rng.integers(64, 601, size=b)
            q = torch.from_numpy(rng.standard_normal((b, hq, d))).to(
                dev).to(dtype)
            ln = torch.from_numpy(lengths.astype(np.int32)).to(dev)
            out[f"decode.{tag}"] = kernel.paged_attn_cuda(q, k, v, tbl, ln)
            for op, lq, off, kvl in (
                    ("verify", 5, rng.integers(320, 596, size=b), None),
                    ("prefill", 512, np.zeros(b, np.int64),
                     rng.integers(64, 513, size=b))):
                kvl = off + lq if kvl is None else kvl
                q = torch.from_numpy(rng.standard_normal(
                    (b, lq, hq, d))).to(dev).to(dtype)
                o, kv = (torch.from_numpy(x.astype(np.int32)).to(dev)
                         for x in (off, kvl))
                out[f"{op}.{tag}"] = kernel.paged_prefill_attn_cuda(
                    q, k, v, tbl, o, kv)
    torch.cuda.synchronize()
    bits = {name: t.contiguous().view(
        torch.int16 if t.dtype == torch.bfloat16 else torch.int32
    ).cpu().numpy() for name, t in out.items()}
    np.savez(path, **bits)
    return {"saved": path, "outputs": sorted(bits)}


def compare_outputs(a: str, b: str) -> dict:
    """Per output of two ``--kernel-outputs`` files: bit-identical?"""
    import numpy as np
    x, y = np.load(a), np.load(b)
    same = {k: bool(k in y.files and np.array_equal(x[k], y[k]))
            for k in sorted(x.files)}
    return {"bit_identical": same, "all": all(same.values())
            and sorted(x.files) == sorted(y.files)}


def main() -> None:
    here = pathlib.Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(here),
                    help="the src directory of the tree to measure")
    ap.add_argument("--primitives", action="store_true",
                    help="time the volume and vector-sum ops and the wave "
                         "step instead of serving")
    ap.add_argument("--moe-train", action="store_true",
                    help="time the MoE train step of chip_smoke's [train] "
                         "(c) and the grouped GEMM's backward instead of "
                         "serving")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--layouts", nargs="+", default=["paged", "dense"],
                    choices=["paged", "dense"])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--graphs-ab", action="store_true",
                    help="serve with CUDA graphs and eagerly, alternating, "
                         "on this one tree")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--kernel-outputs", default=None, metavar="OUT",
                    help="save the paged kernels' default-launch outputs "
                         "(.npz) instead of serving")
    ap.add_argument("--compare-outputs", nargs=2, default=None,
                    metavar=("A", "B"),
                    help="compare two --kernel-outputs files bit for bit")
    args = ap.parse_args()
    if args.compare_outputs:
        res = compare_outputs(*args.compare_outputs)
        print(json.dumps(res))
        raise SystemExit(0 if res["all"] else 1)
    args.src = str(pathlib.Path(args.src).resolve())
    timing = own_timing()
    sys.path[0] = args.src     # this file's directory, when run as a file
    import torch
    import repro_torch
    if pathlib.Path(repro_torch.__file__).resolve().parents[1] != \
            pathlib.Path(args.src):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, "
                         f"not from {args.src}")
    if not torch.cuda.is_available():
        raise SystemExit("serve_ab measures the GPU: no CUDA device")
    if args.kernel_outputs:
        out = kernel_outputs(torch, args.kernel_outputs)
    elif args.moe_train:
        out = moe_train(torch, timing, args)
    else:
        out = (primitives if args.primitives else serve)(torch, timing,
                                                         args)
    print(json.dumps({"src": args.src,
                      "device": torch.cuda.get_device_name(0), **out}))


if __name__ == "__main__":
    main()
