#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the
repository's ``src/`` beside this file; it imports nothing of JAX and
nothing of the JAX package ``repro``.  Phases, each of which fails the run:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: compile the two CUDA extensions from their ``csrc/`` directories
   at once (paged attention: decode and prefill; dense-stripe decode);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in bfloat16 and float32.  Paged, at the full-width qwen2-0.5b geometry
   (Hq 14, Hkv 2, D 64, page 16): ragged lengths, permuted tables, sentinel
   tails, a prefill at mixed depths and a verify at Lq = 5.  Dense stripes,
   at G = 7, D = 64 and G = 4, D = 16: ragged lengths (0, 1, a length above
   the rows read), the whole stripe and a stripe read under ``s_cap`` whose
   rows past it hold NaN.  Then the time of each kernel, of its plain
   version and of ``scaled_dot_product_attention`` on the same K/V (a
   yardstick the port never calls), beside the least time the card could
   take for the same work;
4. serve, paged and dense: full-width qwen2-0.5b (seeded random bfloat16
   weights) through ``repro_torch.launch.serve.run``: 16 requests,
   prompts of 64-512 tokens, 64 new tokens each, batch 8, max_len 1024,
   8 steps per segment; paged with pages of 16, then dense stripes; each
   path's kernel launches are counted over its own run only;
5. agreement: short float32 runs with the same weights: each layout with
   the CUDA kernels on the card against the plain path on the CPU, and the
   dense layout against the paged one on the card: equal greedy streams,
   or a difference shown to sit at a logit near-tie.

Output: one line per check, then a JSON line with the kernels' numbers,
the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core rate
              "float32": 67e12}           # outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
NEAR_TIE = 1e-4
ARCH = "qwen2-0.5b"
HQ, HKV, D, PS = 14, 2, 64, 16


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# inputs and measurement helpers
# ---------------------------------------------------------------------------

def paged_inputs(torch, rng, *, b, depths, n_pages, p_max, dtype, layers=1):
    """Pools [layers, n_pages + 1, PS, HKV, D] (the last page is the
    sink), a permuted table whose rows map ceil(depth / PS) distinct pages
    and end in sentinels (n_pages)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    shape = (layers, n_pages + 1, PS, HKV, D)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    tbl = [[n_pages] * p_max for _ in range(b)]
    perm = list(rng.permutation(n_pages))
    for i, depth in enumerate(depths):
        for j in range(-(-depth // PS)):
            tbl[i][j] = int(perm.pop())
    table = torch.tensor(tbl, dtype=torch.int32, device=dev)
    return k, v, table


def time_ms(torch, fn, calls: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``calls`` launches, by CUDA
    events (after a warm-up)."""
    fn(0)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_inputs(torch, k, v, table, q_pos, kv_len):
    """Gathered [B, HKV, S, D] K/V and the boolean mask of the same
    attention, for ``scaled_dot_product_attention``."""
    from repro_torch.kernels.paged_attn import gather_pages
    kg = gather_pages(k, table).permute(0, 2, 1, 3).contiguous()
    vg = gather_pages(v, table).permute(0, 2, 1, 3).contiguous()
    kpos = torch.arange(kg.shape[2], device=kg.device)
    mask = ((kpos[None, None, :] <= q_pos[:, :, None])
            & (kpos[None, None, :] < kv_len[:, None, None]))[:, None]
    return kg, vg, mask


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(torch) -> dict:
    """Correctness at several shapes and both dtypes; returns, per kernel,
    the largest error at the main path's shape in bfloat16."""
    import numpy as np
    from repro_torch.kernels.paged_attn import ops, ref
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    worst = {"paged_decode": 0.0, "paged_prefill": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        tol = TOL[name]
        # decode: ragged lengths (one token, page edges, deep), sentinels
        lengths = [1, 15, 16, 17, 100, 333, 512, 576]
        k, v, tbl = paged_inputs(torch, rng, b=8, depths=lengths,
                                 n_pages=512, p_max=64, dtype=dtype)
        q = torch.randn(8, HQ, D, device=dev).to(dtype)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = ops.paged_attn(q, k[0], v[0], tbl, ln)
        want = ref.paged_attn_ref(q.float(), k[0].float(), v[0].float(),
                                  tbl, ln)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        print(f"[kernels] decode {name} ragged+sentinel: max_abs_err "
              f"{err:.3e} (tol {tol:g})")
        check(err <= tol and got.dtype == dtype, "decode kernel disagrees")
        if dtype == torch.bfloat16:
            worst["paged_decode"] = max(worst["paged_decode"], err)
        # prefill at mixed depths, a verify (Lq = 5) and the join shape
        for label, lq, offs in (
                ("prefill mixed q_offset", 40, [0, 16, 23, 100, 250, 0, 7,
                                                300]),
                ("verify Lq=5", 5, [12, 64, 99, 130, 255, 256, 400, 511]),
                ("join Lq=512", 512, [0] * 8)):
            kvl = [o + lq for o in offs]
            k, v, tbl = paged_inputs(torch, rng, b=8, depths=kvl,
                                     n_pages=512, p_max=64, dtype=dtype)
            q = torch.randn(8, lq, HQ, D, device=dev).to(dtype)
            off = torch.tensor(offs, dtype=torch.int32, device=dev)
            kv = torch.tensor(kvl, dtype=torch.int32, device=dev)
            got = ops.paged_prefill_attn(q, k[0], v[0], tbl, off, kv)
            want = ref.paged_prefill_attn_ref(q.float(), k[0].float(),
                                              v[0].float(), tbl, off, kv)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            print(f"[kernels] prefill {name} {label}: max_abs_err "
                  f"{err:.3e} (tol {tol:g})")
            check(err <= tol and got.dtype == dtype,
                  f"prefill kernel disagrees ({label})")
            if dtype == torch.bfloat16 and lq == 512:
                worst["paged_prefill"] = max(worst["paged_prefill"], err)
    # non-joining rows of a join: all-sentinel tables must not fault
    k, v, tbl = paged_inputs(torch, rng, b=2, depths=[64, 0], n_pages=8,
                             p_max=4, dtype=torch.bfloat16)
    q = torch.randn(2, 64, HQ, D, device=dev).to(torch.bfloat16)
    z = torch.zeros(2, dtype=torch.int32, device=dev)
    out = ops.paged_prefill_attn(q, k[0], v[0], tbl, z, z + 64)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()),
          "prefill kernel: non-finite output on an all-sentinel row")
    print("[kernels] all-sentinel rows: finite, no fault")
    return worst


def kernel_timings(torch) -> dict:
    """Times at the main path's shapes, bfloat16: 8 slots, pools for 24
    layers walked one layer per call (as the model walks them), decode
    depths over the run's range, and the first join (8 prompts padded to
    512 tokens)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attn import kernel, ops, ref
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    dtype, name, layers, b = torch.bfloat16, "bfloat16", 24, 8
    item = 2
    out = {}

    lengths = [int(x) for x in rng.integers(65, 577, size=b)]
    k, v, tbl = paged_inputs(torch, rng, b=b, depths=lengths, n_pages=512,
                             p_max=64, dtype=dtype, layers=layers)
    ctbl = ops._clamp_table(tbl, k.shape[1])
    q = torch.randn(b, HQ, D, device=dev).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kg, vg, mask = sdpa_inputs(torch, k[0], v[0], tbl,
                               (ln - 1)[:, None], ln)
    q4 = q[:, :, None]
    live = sum(lengths)
    nbytes = (2 * q.numel() * item + live * HKV * D * item * 2
              + tbl.numel() * 4 + b * 4)
    t_bound, by = bound(nbytes, 4.0 * HQ * D * live, name)
    out["paged_decode"] = {
        "ms": time_ms(torch, lambda i: kernel.paged_attn_cuda(
            q, k[i % layers], v[i % layers], ctbl, ln), layers * 4),
        "plain_ms": time_ms(torch, lambda i: ref.paged_attn_ref(
            q, k[i % layers], v[i % layers], tbl, ln).to(dtype), layers),
        "library_ms": time_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, enable_gqa=True), layers * 4),
        "bound_ms": t_bound, "bound_by": by,
        "shape": f"B={b} Hq={HQ} Hkv={HKV} D={D} ps={PS} lengths={lengths}"}

    lq = 512
    k, v, tbl = paged_inputs(torch, rng, b=b, depths=[lq] * b, n_pages=512,
                             p_max=64, dtype=dtype, layers=layers)
    ctbl = ops._clamp_table(tbl, k.shape[1])
    q = torch.randn(b, lq, HQ, D, device=dev).to(dtype)
    off = torch.zeros(b, dtype=torch.int32, device=dev)
    kv = off + lq
    pos = off[:, None] + torch.arange(lq, device=dev)[None, :]
    kg, vg, mask = sdpa_inputs(torch, k[0], v[0], tbl, pos, kv)
    q4 = q.permute(0, 2, 1, 3).contiguous()
    visible = b * lq * (lq + 1) // 2
    nbytes = (2 * q.numel() * item + b * lq * HKV * D * item * 2
              + tbl.numel() * 4 + 2 * b * 4)
    t_bound, by = bound(nbytes, 4.0 * HQ * D * visible, name)
    out["paged_prefill"] = {
        "ms": time_ms(torch, lambda i: kernel.paged_prefill_attn_cuda(
            q, k[i % layers], v[i % layers], ctbl, off, kv), layers),
        "plain_ms": time_ms(torch, lambda i: ref.paged_prefill_attn_ref(
            q, k[i % layers], v[i % layers], tbl, off, kv), layers, reps=3),
        "library_ms": time_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, enable_gqa=True), layers),
        "bound_ms": t_bound, "bound_by": by,
        "shape": f"B={b} Lq={lq} q_offset=0 kv_len={lq} Hq={HQ} Hkv={HKV} "
                 f"D={D} ps={PS}"}
    for kname, row in out.items():
        print(f"[timing] {kname} {name} ({row['shape']}): kernel_ms "
              f"{row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, "
              f"library_ms {row['library_ms']:.4f}, bound_ms "
              f"{row['bound_ms']:.4f} ({row['bound_by']})")
    return out


def stripe_checks(torch) -> float:
    """The dense-stripe decode kernel against its plain version, at the
    full-width (G = 7, D = 64) and reduced (G = 4, D = 16) geometries, in
    both dtypes, over the whole stripe and under ``s_cap``; returns the
    largest error at the full-width geometry in bfloat16."""
    from repro_torch.kernels.decode_attn import decode_attn, decode_attn_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    b, s = 8, 1025
    lengths = [0, 1, 63, 64, 65, 300, 700, 1100]
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        tol = TOL[name]
        for hq, hkv, d in ((HQ, HKV, D), (4, 1, 16)):
            q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
            for s_cap in (None, 512):
                cap = s if s_cap is None else s_cap
                k, v = (torch.randn(b, s, hkv, d, generator=gen,
                                    device=dev).to(dtype) for _ in "kv")
                k[:, cap:] = float("nan")        # never read under s_cap
                v[:, cap:] = float("nan")
                got = decode_attn(q, k, v, ln, s_cap=s_cap)
                want = decode_attn_ref(q.float(), k[:, :cap].float(),
                                       v[:, :cap].float(), ln)
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                finite = bool(torch.isfinite(got.float()).all())
                zero = bool((got[0] == 0).all())
                print(f"[kernels] decode_attn {name} G={hq // hkv} D={d} "
                      f"s_cap={cap} of {s} rows, lengths {lengths}: "
                      f"max_abs_err {err:.3e} (tol {tol:g}); finite "
                      f"{finite}; length-0 slot zeros {zero}")
                check(err <= tol and got.dtype == dtype,
                      "decode_attn kernel disagrees")
                check(finite and zero, "decode_attn kernel: the length-0 "
                      "slot is not finite zeros")
                if dtype == torch.bfloat16 and d == D:
                    worst = max(worst, err)
    return worst


def stripe_timing(torch) -> dict:
    """Time at the dense decode step's shapes, bfloat16: 8 slots at
    depths over the serve run's range, stripes of max_len + 1 = 1025 rows
    for 24 layers walked one layer per call, ``s_cap`` the scheduler's
    row bucket for an 8-step segment."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import decode_attn_ref, kernel
    from repro_torch.serve.scheduler import _pow2_bucket
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    dtype, name, layers, b, max_len, item = (torch.bfloat16, "bfloat16", 24,
                                             8, 1024, 2)
    lengths = [int(x) for x in rng.integers(65, 577, size=b)]
    cap = min(_pow2_bucket(max(lengths) + 8, hi=max_len), max_len)
    shape = (layers, b, max_len + 1, HKV, D)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    q = torch.randn(b, HQ, D, generator=gen, device=dev).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q4 = q[:, :, None]
    kt = [k[i, :, :cap].transpose(1, 2) for i in range(layers)]
    vt = [v[i, :, :cap].transpose(1, 2) for i in range(layers)]
    mask = (torch.arange(cap, device=dev)[None, :]
            < ln[:, None])[:, None, None, :]
    live = sum(min(n, cap) for n in lengths)
    nbytes = 2 * q.numel() * item + live * HKV * D * item * 2 + b * 4
    t_bound, by = bound(nbytes, 4.0 * HQ * D * live, name)
    row = {
        "ms": time_ms(torch, lambda i: kernel.decode_attn_cuda(
            q, k[i % layers], v[i % layers], ln, cap), layers * 4),
        "plain_ms": time_ms(torch, lambda i: decode_attn_ref(
            q, k[i % layers, :, :cap], v[i % layers, :, :cap],
            ln).to(dtype), layers),
        "library_ms": time_ms(torch, lambda i: F.scaled_dot_product_attention(
            q4, kt[i % layers], vt[i % layers], attn_mask=mask,
            enable_gqa=True), layers * 4),
        "bound_ms": t_bound, "bound_by": by,
        "shape": f"B={b} Hq={HQ} Hkv={HKV} D={D} S={max_len + 1} "
                 f"s_cap={cap} lengths={lengths}"}
    print(f"[timing] decode_attn {name} ({row['shape']}): kernel_ms "
          f"{row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, library_ms "
          f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} "
          f"({row['bound_by']})")
    return row


# ---------------------------------------------------------------------------
# phases 4 and 5: the serving paths
# ---------------------------------------------------------------------------

def reset_counts() -> None:
    from repro_torch.kernels import decode_attn, paged_attn
    paged_attn.reset_launch_counts()
    decode_attn.reset_launch_counts()


def read_counts() -> dict:
    from repro_torch.kernels import decode_attn, paged_attn
    return {**paged_attn.launch_counts, **decode_attn.launch_counts}


def serve_full_width(torch, paged: bool) -> dict:
    """One path's serve run; returns that run's kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run
    cfg = get_config(ARCH)
    requests, max_new, batch, sync = 16, 64, 8, 8
    layout = "paged" if paged else "dense"
    reset_counts()
    res = run(ARCH, requests=requests, max_new=max_new, batch=batch,
              max_len=1024, paged=paged, page_size=16, sync_every=sync,
              seed=0, prompt_len=(64, 513), dtype=torch.bfloat16,
              device="cuda")
    counts = read_counts()
    lens = sorted(len(p) for p in res["prompts"].values())
    print(f"[serve] {layout}: prompts {lens[0]}-{lens[-1]} tokens; tok/s "
          f"{res['tok_per_s']:.1f}; launches {counts}")
    check(sorted(res["results"]) == list(range(requests)),
          f"serve {layout}: missing requests")
    for rid, toks in res["results"].items():
        check(len(toks) == max_new and all(0 <= t < cfg.vocab for t in toks),
              f"serve {layout}: request {rid} returned {len(toks)} tokens")
    steps = cfg.n_layers * sync * res["segments"]
    if paged:
        check(counts["paged_prefill"] == cfg.n_layers * res["joins"],
              "serve paged: prefill launches != layers x joins")
        check(counts["paged_decode"] == steps,
              "serve paged: decode launches != layers x steps")
        check(counts["decode_attn"] == 0,
              "serve paged: the dense decode kernel was launched")
    else:
        check(counts["decode_attn"] == steps,
              "serve dense: decode_attn launches != layers x steps")
        check(counts["paged_decode"] == counts["paged_prefill"] == 0,
              "serve dense: a paged kernel was launched")
    return counts


def _near_tie(torch, params, cfg, prompt, got, want, label) -> bool:
    """Equal streams (False), or a first difference at a logit near-tie of
    the plain float32 forward after the common prefix (True); anything
    else fails the run."""
    from repro_torch.models.transformer import forward, logits_fn
    if got == want:
        return False
    diff = [j for j in range(min(len(got), len(want))) if got[j] != want[j]]
    check(bool(diff), f"agreement {label}: lengths differ")
    i = diff[0]
    toks = torch.tensor([prompt + want[:i]])
    hidden, _ = forward(params, {"tokens": toks}, cfg, dtype=torch.float32)
    logits = logits_fn(params, hidden[:, -1:], cfg)[0, 0]
    gap = abs(float(logits[got[i]] - logits[want[i]]))
    print(f"[agree] {label} differs at token {i}: logit gap {gap:.2e} "
          f"between {got[i]} and {want[i]}")
    check(gap < NEAR_TIE, f"agreement {label}: differs without a near-tie")
    return True


def agreement(torch) -> None:
    """float32, same seeded weights: each layout's CUDA kernel path vs its
    CPU plain path, and the dense layout vs the paged one on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run
    from repro_torch.models.init import init_params
    cfg = get_config(ARCH)
    params = init_params(cfg, 1, device="cuda")
    cpu_params = _to(torch, params, "cpu")
    kw = dict(requests=3, max_new=8, batch=2, max_len=128, page_size=16,
              sync_every=4, seed=1, prompt_len=(16, 40),
              dtype=torch.float32)
    streams = {}
    for paged in (True, False):
        layout = "paged" if paged else "dense"
        on_card = run(ARCH, device="cuda", params=params, paged=paged,
                      **kw)["results"]
        on_cpu = run(ARCH, device="cpu", params=cpu_params, paged=paged,
                     **kw)
        prompts, on_cpu = on_cpu["prompts"], on_cpu["results"]
        ties = sum(_near_tie(torch, cpu_params, cfg, prompts[rid],
                             on_card[rid], want, f"{layout} request {rid}")
                   for rid, want in on_cpu.items())
        print(f"[agree] float32 greedy streams, {layout}, CUDA kernels vs "
              f"CPU plain path: {len(on_cpu) - ties}/{len(on_cpu)} equal, "
              f"{ties} at near-ties")
        streams[layout] = on_card
    ties = sum(_near_tie(torch, cpu_params, cfg, prompts[rid],
                         streams["dense"][rid], want, f"dense vs paged "
                         f"request {rid}")
               for rid, want in streams["paged"].items())
    print(f"[agree] float32 greedy streams on the card, dense kernel vs "
          f"paged kernels: {len(prompts) - ties}/{len(prompts)} equal, "
          f"{ties} at near-ties")


def _to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(torch, v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels.decode_attn import kernel as dense_kernel
        from repro_torch.kernels.paged_attn import kernel as paged_kernel
    except ImportError as err:
        print(f"chip_smoke: the port is not importable: {err}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; allow_tf32 off for matmul and cuDNN")

    def build(mod):
        t0 = time.perf_counter()
        mod.load_extension()
        return time.perf_counter() - t0
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        t_paged, t_dense = pool.map(build, (paged_kernel, dense_kernel))
    print(f"[build] both extensions built at once in "
          f"{time.perf_counter() - t0:.1f}s (paged attention "
          f"{t_paged:.1f}s, decode_attn {t_dense:.1f}s)")

    worst = kernel_checks(torch)
    worst["decode_attn"] = stripe_checks(torch)
    timings = kernel_timings(torch)
    timings["decode_attn"] = stripe_timing(torch)
    counts = serve_full_width(torch, paged=True)
    dense_counts = serve_full_width(torch, paged=False)
    counts["decode_attn"] = dense_counts["decode_attn"]
    agreement(torch)

    sources = {"paged_decode": ("src/repro_torch/kernels/paged_attn/csrc/"
                                "paged_decode.cu",
                                "src/repro/kernels/paged_attn/kernel.py:107"),
               "paged_prefill": ("src/repro_torch/kernels/paged_attn/csrc/"
                                 "paged_prefill.cu",
                                 "src/repro/kernels/paged_attn/"
                                 "prefill_kernel.py:138"),
               "decode_attn": ("src/repro_torch/kernels/decode_attn/csrc/"
                               "decode_attn.cu",
                               "src/repro/kernels/decode_attn/kernel.py:82")}
    rows = []
    for name, (src, replaces) in sources.items():
        t = timings[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": worst[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
        check(all(isinstance(v, (int, float)) and math.isfinite(v)
                  for k, v in rows[-1].items()
                  if k in ("ms", "plain_ms", "bound_ms", "library_ms")),
              f"{name}: a timing is not a finite number")
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        sys.exit(1)
