#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the
repository's ``src/`` beside this file; it imports nothing of JAX and
nothing of the JAX package ``repro``.  Phases, each of which fails the run:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: compile the eight CUDA extensions from their ``csrc/``
   directories at once (paged attention: decode and prefill; dense-stripe
   decode; skinny GEMM: masked and compact; push scatter; wavesim volume;
   wavesim flux; vector-sum; the grouped expert GEMM), and beside them
   ``volume.cu`` alone through ``repro_torch.launch.sass_check``: its
   registers, spills and CTAs an SM, and that each product run is one
   row's 189 FFMAs with constant-bank weights and no LDC, LDL or STL;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in bfloat16 and float32.  Paged, at the full-width qwen2-0.5b geometry
   (Hq 14, Hkv 2, D 64, page 16): decode at the serve batch of 8 through
   the op (so at the launch the committed tuned entry gives) and at every
   split count (1, 2, 4, 8) and rows a CTA (1, 2, 4) a tuned entry can
   give, over lengths 0, 1, page edges, the whole table and one key
   before, at and past every rank boundary of the split-KV walk, permuted
   tables, sentinel tails, the pool rows past each length NaN; a prefill
   at mixed depths, a verify at Lq = 5 and a join, through the op and at
   16, 32 and 64 rows a CTA; the same at the full-width moonshot geometry
   (Hq 16, Hkv 16: G = 1, D = 128) and at the three dense families'
   (starcoder2-3b Hq 24, Hkv 2: G 12; nemotron-4-15b Hq 48, Hkv 8: G 6;
   codeqwen1.5-7b Hq 32, Hkv 32: G 1; all D 128).  Dense
   stripes, at G = 7, D = 64, G = 4, D = 16, G = 1, D = 128 and the
   families' three geometries: ragged
   lengths (0, 1, a length above the rows read, rank boundaries +-1), the
   whole stripe and a stripe read under ``s_cap`` whose rows past it hold
   NaN.  The
   grouped expert GEMM in bfloat16 and float32: ``test_kernels_moe.py``'s
   sweep, empty and full experts, a ragged C, rows that are not 16 bytes,
   and full-width moonshot's expert shapes at decode (C 1) and at a
   4,096-token join (C 480) with counts from a seeded routing; the rows
   past each count exactly zero though the padding holds NaN; and
   full-width deepseek-v3's (E 256, top-8, D 7168, F 2048, gate/up and
   down) at decode (C 1) and at a 4,096-token join (C 160), the same
   way, the float64 product 32 experts at a time.  Skinny
   GEMM, masked and compact, in bfloat16 and float32 on both routes (the
   tensor-core walk for aligned bfloat16, the CUDA-core walk for the
   rest, counted by ``route_counts``): N 1-16, ragged M and K, densities
   0, 0.05 and 1, budgets 1, the live count and every block (the overflow
   guard included), and A's columns NaN in every block a walk skips.  Push
   scatter: every update hot, every update cold, hot == n < 1024, hot
   1024, U a multiple of no tile.  Wave volume, float32 and bfloat16,
   (E, F) from (1, 1) to ``Problem()``'s (64000, 27), c 1.0 and 0.7, and
   row counts that end the persistent walk anywhere in its ring (1, 255,
   257, a tile a CTA +-1, a walk that wraps the ring) on an aligned and an
   unaligned base, each within the bounds of 27-term and of the stencil's
   7-term sums; an off-pattern W refused;
   wave flux1d, (E, T) from (1, 9) to (64000, 243), alpha 0.5 (equal to
   the plain version) and 0.3 (within one ulp); vector-sum in float32,
   bfloat16 and float16 from 0 to 64 Mi elements, a 3-D shape, the
   lengths where its spans change shape +-1, and an unaligned view
   (exactly a + b).  The summing kernels are held per
   output to the worst-case bound of float32 summation against float64
   results from the same inputs.  Then the time of each kernel, of its
   plain version and of one library call (``scaled_dot_product_attention``,
   ``torch.bmm``, ``torch.matmul``, ``index_add``, ``torch.add``;
   yardsticks the port never calls), beside the least time the card could
   take for the same work; the prefill kernel also as the speculative
   verify at the features phase's shape (8 slots, Lq 5, depths 320-600),
   on the device alone too, beside SDPA and the decode kernel's time at
   the same depths times 5; the attention kernels also at moonshot's
   geometry over 48 layers and at each dense family's over its layers,
   the grouped GEMM at decode and at a join (its gate/up and its down
   projection) with its tiles skipped, at moonshot's expert shapes and
   at deepseek's, and the
   achieved TFLOP/s and share of the bound of the kernels redesigned for
   the tensor cores (bf16 prefill, the grouped GEMM at a join, both
   ss-gemm walks at N 16); the two decode kernels and SDPA also on the
   device alone (the same calls captured in one CUDA graph and replayed),
   with each split count, GB/s, share of the bound and the wrapper's host
   us a call; ss-gemm's two routes side by side at N 2-16; volume (both
   dtypes) and vector-sum on the device alone too, against
   ``torch.matmul`` and ``torch.add`` timed the same way (``[timing]
   redesigned primitives``);
4. serve, paged and dense: full-width qwen2-0.5b (seeded random bfloat16
   weights) through ``repro_torch.launch.serve.run``: 16 requests,
   prompts of 64-512 tokens, 64 new tokens each, batch 8, max_len 1024,
   8 steps per segment; paged with pages of 16, then dense stripes; each
   layout with its decode segments replayed as one CUDA graph per bucket
   (the default, the main path) and eagerly, each run a first wave and a
   warm wave of the same prompts after ``reset_stats``: tok/s of both
   waves, the seconds spent capturing, TTFT and TPOT, peak memory; equal
   greedy streams from graphs and eager, and from both waves; each run's
   kernel launches are counted over its own run only, exactly (a graph's
   launches count at each replay).  Then the serving features, paged:
   16 requests of a seeded 256-token shared prefix and a 64-256-token
   suffix, (a) with the prefix cache, chunked prefill (128) and a round
   budget (256 tokens), (b) with speculation (k 4) as well, each graphed
   and eager, and the same traffic with every feature off: prefix,
   chunk and speculation statistics, both waves' tok/s and latencies;
   graphed and eager streams equal for (a) and (b), prefix hits,
   skipped prefill and chunk continuations in the first wave, and the
   launches exact (speculating, the prefill kernel runs once a layer for
   each join and each verify step, the decode kernel never).  Then
   optimistic admission on the paged cell's traffic and a pool of 152
   pages (160 preempt once; 152 is the largest below it, in steps of 8,
   that preempts at least twice), graphed and eager, and graphed the
   same with a chaos slot failure at round 3 and reserve admission on
   that pool: preemptions, recomputed tokens, peak live slots and KV use
   against reserve, tok/s and latencies of both waves; gated: graphed =
   eager, the warm wave = the first, at least 2 preemptions, every
   preempted request completed, one slot failure, a drained pool
   (``KVPool.check``) and exact launches (resume joins count as joins);
   bf16 streams against phase 4's 512-page run are counted, with the
   float32 margin where they part.  Then overload protection and tracing
   (``[overload]`` lines), graphed: the paged cell traced into a Perfetto
   file (streams equal to the untraced run's, the file parses, one
   RETIRE a SUBMIT, every request's attribution partition exact; warm
   tok/s traced against untraced printed); the features cell's (b)
   traffic with the degradation ladder forced (pressure 0.01, up 1 round,
   down 50: a transition, no cancellation, every request complete,
   launches exact split between plain and verify steps); optimistic
   admission on 152 pages with the controller at its defaults, SLOs at
   the paged cell's warm TTFT and TPOT p50 and a chaos burst of 16
   low-priority requests at round 2 with that TTFT as their deadline
   (every request in exactly one of results or cancelled, a drained pool;
   transitions, time in state, sheds, RETRY_AFTER answers, cancels by
   reason, deadline attainment, tok/s and capture seconds printed); and
   the watchdog drill, a chaos stall of 12 rounds under an 8-round
   watchdog (a trip, a ``WatchdogStall`` flight bundle written, the shed
   request answered RETRY_AFTER, the rest complete, a drained pool).
   Then the ``[autotune]`` phase: a bounded sweep (budget 8, 3 replays)
   of the paged decode, prefill and verify at full-width qwen2-0.5b's and
   moonshot's geometry in bf16 at the serve cells' shapes
   (``repro_torch.launch.autotune.sweep``, nothing saved): every
   candidate's device ms, parity error against the default launch and
   bit-exactness; gated: the winner no slower than the default, every
   measured candidate within the parity gate, and the committed entries
   of ``tuned_shapes.json`` loaded by the policy for all six keys; then an
   eager paged qwen wave (8 requests) with the attention telemetry on:
   each op's calls equal to its kernel's launches, none captured,
   achieved GB/s under 1.05 x 3,350, the amenability verdicts printed;
5. agreement: short float32 runs with the same weights: each layout with
   the CUDA kernels (graphed) on the card against the plain path on the
   CPU and against the eager loop on the card, and the dense layout
   against the paged one on the card; paged with ``attn_mode="plain"``
   (gather, then plain attention, on the card) against ``"kernel"``:
   equal streams, joins and segments; then paged behind a 32-token shared
   prefix with the prefix cache, chunks of 16 and speculation (k 3), card
   against CPU (with equal prefix, spec and chunk statistics where the
   streams are equal) and features on against off on the card; then
   optimistic admission on a 5-page pool (one wave of 4 requests, 16 new
   tokens, batch 2, through the ``Batcher``: it preempts), plain, with a
   chaos slot failure and with the prefix cache, card against CPU (equal
   ``preempt_stats`` where the streams are equal), graphed against eager
   and against reserve on an ample pool; then the forced ladder (with the
   prefix cache and chunks of 16, and with speculation alone, which
   verifies and then sheds speculation mid-run) and the watchdog drill,
   each card against CPU, graphed against eager and traced against
   untraced, with equal transitions, cancellations and rejections: equal
   greedy streams, or a difference shown to sit at a logit near-tie;
6. primitives at the paper's sizes, through the public ops: ss-gemm on
   ``ss_gemm.Problem()`` (M 16,384 x K 4,096, bfloat16) for N 2, 4, 8 and
   16, with ``make_skinny`` data and with a clustered B (45% of 256-row
   blocks live): dense, masked, and compact at the live count and half of
   it; one push iteration on each of the three ``graphs.paper_inputs``
   graphs in full (57.6 M, 10 M and 100 M updates).  Each against its
   float64 oracle, with the blocks skipped and the hot share printed;
   every ss-gemm launch there takes the tensor-core route;
7. the wave path: ``repro_torch.launch.wave_demo.run`` at the demo's size
   (8^3 grid, 3 fields, 40 steps, float32) with the volume kernel on the
   card against the plain path on the CPU; at ``wavesim.Problem()`` (40^3
   elements, 27 fields, float32, seeded on the card) one step against a
   float64 step from the same input, then 5 steps timed by CUDA events
   with the volume term's share; ``flux1d`` (E 64,000 x T 243) and
   ``vector_sum`` (64 Mi float16 elements) through their public ops;
8. MoE agreement: full-width moonshot-v1-16b-a3b cut to 1 dense + 2 MoE
   layers, seeded float32 weights, each layout's CUDA kernels on the card
   against the plain path on the CPU, graphed against eager on the card
   and dense against paged on the card (batch 2, capacities of 1-15, so
   choices drop): equal greedy streams or a difference at a logit
   near-tie; the grouped GEMM's launches counted, graphed and eager;
9. MoE serve: full-width, full-depth moonshot-v1-16b-a3b (48 layers, 64
   experts top-6, seeded bfloat16 weights built in place once, about 58
   GB) through ``repro_torch.launch.serve.run``, paged with pages of 16,
   the qwen serve cell's traffic, graphed and eager as in phase 4;
   launches of the grouped GEMM (3 per MoE layer and forward call) and of
   both paged kernels checked, tok/s of both waves, capture seconds and
   peak device memory with graphs printed;
10. ``[families]``: starcoder2-3b, nemotron-4-15b and codeqwen1.5-7b at
   full width and full depth, then deepseek-v3 at full width cut to 3
   dense + 1 MoE layer of 61 (every width, all 256 experts, the vocab and
   the MTP block kept), each built in place from seeded bfloat16 weights
   and freed before the next, served paged on phase 4's traffic, graphed,
   a first and a warm wave: warm tok/s, TTFT and TPOT p50, peak device
   memory, launches exact (deepseek's multi-head latent attention runs no
   attention kernel; its grouped GEMM 3 a MoE layer and forward call);
   deepseek also with the prefix cache, chunks of 128 and speculation
   (k 4) behind a 256-token shared prefix.  Then each of the four at
   ``reduced()`` in float32, card (graphs) against the CPU's plain path,
   paged and dense (deepseek also with the prefix cache, chunks of 16 and
   speculation k 3): equal greedy streams or a difference at a logit
   near-tie;
11. ``[ssm]``: the attention kernels at zamba2-1.2b's shared-block
   geometry (Hq 32, Hkv 32: G 1, D 64), which no earlier phase launches:
   both paged kernels at every split and rows a CTA and the dense-stripe
   kernel over the whole stripe and under ``s_cap``, in both dtypes,
   against their plain versions, and their times over the block's 5
   occurrences beside SDPA; then mamba2-370m (48 Mamba-2 blocks, no
   attention) and zamba2-1.2b (33 Mamba-2 blocks, the shared block at 5
   occurrences) at full width and full depth, each built in place from
   seeded bfloat16 weights and freed before the next, served paged on
   phase 4's traffic, graphed, a first and a warm wave (zamba2 also on
   dense stripes): warm tok/s, TTFT and TPOT p50, peak device memory,
   launches exact (none for mamba2; for zamba2 5 a decode step and 5 a
   join); both at ``reduced()`` in float32, card (graphs) against the
   CPU's plain path, paged and dense; and the padding invariant on the
   card: a 10-token prompt's stream alone and beside a 30-token prompt,
   equal or a difference at a logit near-tie;
12. ``[train]``: (a) the grouped GEMM's backward (dxe through the kernel,
   dw through ``torch.bmm``) against autograd through its plain version
   at moonshot's and deepseek's expert shapes of a 4,096-token join,
   gate/up and down, both dtypes, dy NaN past each count (dxe's rows
   there exactly 0), and its bfloat16 times beside two ``torch.bmm``
   calls and its bound; (b) full-width, full-depth qwen2-0.5b trained
   through ``repro_torch.launch.train.run`` at L 4,096, batch 8 in 2
   microbatches, 12 steps, checkpoints every 4, a failure injected at
   step 9 and restored: finite losses and grad norms, the last
   checkpoint restored bit for bit, the loss falling; step ms, tokens/s,
   model TFLOP/s, peak memory, checkpoint bytes and stall; (c) the
   full-width moonshot cut to 1 dense + 1 MoE layer trained 4 steps:
   every gradient finite, the experts' non-zero, ``group_gemm`` launches
   exact (forward, recompute, backward); (d) 3 float32 train steps at
   ``reduced()`` of qwen2-0.5b, moonshot, deepseek-v3, mamba2 and zamba2,
   card against the CPU's plain path;
13. ``[encdec]``: (a) the attention kernels at whisper-tiny's geometry
   (Hq 6, Hkv 6: G 1, D 64; 48 (slot, KV head) rows at the serve batch),
   which no earlier phase launches: both paged kernels at every split
   and rows a CTA, ragged lengths and rank boundaries, NaN past each
   length, and the dense-stripe kernel over the whole stripe and under
   ``s_cap``, both dtypes, against their plain versions, and their times
   over whisper's 4 decoder layers beside SDPA; (b) whisper-tiny at full
   width and depth (seeded bf16 weights): 8 rows of 1,500 seeded stub
   frames, ``encode``, prompts of 4-64 tokens, ``Model.prefill`` on
   dense stripes (the frames encoded in the call) and
   ``Model.prefill_paged`` (the encoder's ``cross_kv``), each then 64
   greedy ``decode_step``s with ``extra={"cross_kv"}``, launches exact;
   in float32 the kernel route's streams against ``DecodeAttnPolicy``
   mode ``plain``, dense and paged; then text-only serving through both
   batchers on phase 4's traffic, graphed; (c) internvl2-26b at full
   width and full depth (48 layers, about 42 GB built in place): 8 rows
   of 256 seeded vision embeddings and 8-64 text tokens,
   ``Model.prefill_paged`` and 64 greedy ``decode_step``s on pages, then
   text-only paged serving on phase 4's traffic, graphed, and its decode
   step profiled (``profile_serve.profile_decode``, which builds the same
   seeded weights once the phase's are freed);
   (d) both models at ``reduced()`` in float32, card against the CPU's
   plain path: prefill and decode logits with the frames or the vision
   prefix, dense and paged, and ``Model.loss`` with its gradients; (e)
   whisper-tiny at full width trained 4 steps (batch 8 x L 448, text
   only, as JAX's ``launch/train.py``): finite losses, the leaves no
   text-only call reads (the per-layer cross k and v among them) with
   zero gradients, moved by weight decay only;
14. ``[pim]``: (a) the paper's model through
   ``repro_torch.launch.figures.run`` in full (Figures 6, 8, 9 and 10,
   the headline, the limit studies; host arithmetic), the headline
   averages finite; then, counts set to 0, (b) ``launch.quickstart`` on
   the card: the masked skinny GEMM, the volume term and dense decode
   attention at the JAX example's float32 shapes, each against its plain
   version (float32 summation bounds, 1e-4); (c)
   ``launch.figures.kernel_bench`` on the card: ``block_occupancy`` of
   the random and clustered B equal to numpy's, the masked products at
   ``Problem()``'s M within the float32 bound of the float64 oracle, and
   ``group_gemm`` at deepseek-v3's full expert width (E 256, D 7168, F
   2048, bf16) for T 128 and 4,096, its tiles counted on the card equal
   to ``kernel.tile_counts``; launches exact; (d) printed, not gated:
   the paper's GPU model at the card's HBM rate beside the card's time
   for the same ``Problem`` (vector-sum, volume, flux, ss-gemm N 2-16).

Output: one line per check, then a JSON line with the kernels' numbers
(the attention rows carry moonshot's D 128 times as ``d128_*`` and the
dense families' as ``g12_*`` (starcoder2), ``g6_*`` (nemotron) and
``mha_*`` (codeqwen), their ``[families]`` launches as
``families_launches``, zamba2's shared-block geometry's as ``z64_*``
(with its checks' ``z64_max_abs_err``) and its ``[ssm]`` launches as
``ssm_launches``, whisper-tiny's geometry's as ``w64_*`` (with its
checks' ``w64_max_abs_err``) and the ``[encdec]`` launches as
``encdec_launches``, the
prefill row the verify's as ``verify_*``, the paged rows this run's sweep
as ``autotune`` (per geometry and op: winner, its and the default's
device ms, candidates measured and dropped), the
attention, volume and vector-sum rows their device-only ``graph_ms``,
the library call's ``library_graph_ms`` beside it,
volume's row its bfloat16 times
as ``bf16_*``, the grouped GEMM's row the join's as ``prefill_*`` and
``down_*``, deepseek's expert shapes as ``ds_*``, ``ds_prefill_*`` and
``ds_down_*`` and the deepseek cut's launches as ``deepseek_launches``,
the backward's as ``bwd_*``, ``bwd_down_*`` and ``ds_bwd_*``, the
``[train]`` phase's qwen step as ``train_*`` and its moonshot launches as
``train_launches``, the ``[pim]`` phase's launches as ``pim_launches``,
the ss-gemm rows N 16's as ``n16_*``), the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.device import sm_count
    from repro_torch.launch.timing import graph_ms, host_us, time_ms
except ImportError:         # main() reports that the port is missing
    sm_count = graph_ms = host_us = time_ms = None

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core rate
              "float32": 67e12}           # outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
NEAR_TIE = 1e-4
UNIT_ROUNDOFF = 2.0 ** -24                # float32
SEED = 0
ARCH = "qwen2-0.5b"
HQ, HKV, D, PS = 14, 2, 64, 16
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_GEO = (16, 16, 128)                   # its Hq, Hkv, head_dim (G 1)
# the dense decoders served beside qwen: their attention geometries (Hq,
# Hkv, head_dim) and the prefixes of their times in the JSON line
FAMILIES = {"starcoder2-3b": ("g12", (24, 2, 128)),
            "nemotron-4-15b": ("g6", (48, 8, 128)),
            "codeqwen1.5-7b": ("mha", (32, 32, 128))}
MLA_ARCH = "deepseek-v3-671b"             # its times: the "ds_" prefix
# the SSM models of the [ssm] phase; zamba2's shared block attends at
# (Hq, Hkv, head_dim) = (32, 32, 64), G 1: its times the "z64_" prefix
SSM_ARCHS = ("mamba2-370m", "zamba2-1.2b")
ZAMBA_GEO = (32, 32, 64)
SMI = ""                                  # nvidia-smi's name, power limit


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# inputs and measurement helpers
# ---------------------------------------------------------------------------

def paged_inputs(torch, rng, *, b, depths, n_pages, p_max, dtype, layers=1,
                 hkv=HKV, d=D):
    """Pools [layers, n_pages + 1, PS, hkv, d] (the last page is the
    sink), a permuted table whose rows map ceil(depth / PS) distinct pages
    and end in sentinels (n_pages)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    shape = (layers, n_pages + 1, PS, hkv, d)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    tbl = [[n_pages] * p_max for _ in range(b)]
    perm = list(rng.permutation(n_pages))
    for i, depth in enumerate(depths):
        for j in range(-(-depth // PS)):
            tbl[i][j] = int(perm.pop())
    table = torch.tensor(tbl, dtype=torch.int32, device=dev)
    return k, v, table


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def poisoned(torch, k, v, table, lengths, n_pages):
    """Copies of the pools k/v [n_pages + 1, PS, Hkv, D] whose rows past
    each slot's length in its last page, unused pages and the sink (page
    ``n_pages``) hold NaN, so that a read past a slot's length shows."""
    kp, vp = k.clone(), v.clone()
    used = torch.zeros(n_pages + 1, dtype=torch.bool, device=k.device)
    for i, n in enumerate(lengths):
        pages = table[i, :-(-n // PS)].long()
        used[pages] = True
        if n % PS:
            kp[pages[-1], n % PS:] = float("nan")
            vp[pages[-1], n % PS:] = float("nan")
    kp[~used] = float("nan")
    vp[~used] = float("nan")
    return kp, vp


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

def kernel_checks(torch, geo=(HQ, HKV, D)) -> dict:
    """Correctness at several shapes and both dtypes, at the attention
    geometry ``geo`` = (Hq, Hkv, D); returns, per kernel, the largest
    error at the main path's shape in bfloat16.  The decode kernel is
    checked through the op at the serve batch (the launch the committed
    tuned entry gives) and at every split count and rows a CTA a tuned
    entry can give; the prefill kernel at every rows a CTA."""
    import itertools

    import numpy as np
    from repro_torch.kernels.decode_attn.ops import DecodeAttnPolicy
    from repro_torch.kernels.paged_attn import kernel, ops, ref, split
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hq, hkv, d = geo
    at = f"Hq={hq} Hkv={hkv} D={d}"
    worst = {"paged_decode": 0.0, "paged_prefill": 0.0}
    # decode at the serve batch of 8, so at the serve run's launch (the
    # committed tuned entry's knobs, as serving resolves them), then at
    # every (split count, rows a CTA): lengths 0, 1, page edges, deep, the
    # whole table, and one key before, at and past every rank boundary,
    # in batches of 8
    bound = 64 * PS
    tuned = DecodeAttnPolicy().tuned_config(
        "decode", hq=hq, hkv=hkv, d=d, page_size=PS) or {}
    cps = tuned.get("ctas_per_sm", split.CTAS_PER_SM)
    rows = tuned.get("cta_rows", split.CTA_ROWS)
    serve_splits = split.split_count(8, hkv, hq // hkv, bound,
                                     sm_count(torch.device("cuda", 0)),
                                     cps, rows)
    knobs = [(None, None)] + list(itertools.product(
        (1, 2, 4, split.MAX_SPLITS), split.CTA_ROWS_CHOICES))
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        tol = TOL[name]
        for splits, cta_rows in knobs:
            n_ranks = serve_splits if splits is None else splits
            lengths = sorted({0, 1, 15, 16, 17, 100, 333, 512, 576, bound}
                             | set(split.boundary_lengths(n_ranks, bound)))
            errs, finite, zero = [], True, True
            for i in range(0, len(lengths), 8):
                batch = (lengths[i:i + 8] + lengths)[:8]
                k, v, tbl = paged_inputs(torch, rng, b=8, depths=batch,
                                         n_pages=512, p_max=64, dtype=dtype,
                                         hkv=hkv, d=d)
                kp, vp = poisoned(torch, k[0], v[0], tbl, batch, 512)
                q = torch.randn(8, hq, d, generator=gen,
                                device=dev).to(dtype)
                ln = torch.tensor(batch, dtype=torch.int32, device=dev)
                if splits is None:
                    got = ops.paged_attn(q, kp, vp, tbl, ln)
                    check(kernel.last_launch["paged_decode"]
                          == {"splits": serve_splits, "cta_rows": rows},
                          "decode kernel: not the serve batch's launch")
                else:
                    got = kernel.paged_attn_cuda(
                        q, kp, vp, ops._clamp_table(tbl, kp.shape[0]), ln,
                        cta_rows=cta_rows, splits=splits)
                want = ref.paged_attn_ref(q.float(), k[0].float(),
                                          v[0].float(), tbl, ln)
                torch.cuda.synchronize()
                errs.append((got.float() - want).abs().max().item())
                finite &= bool(torch.isfinite(got.float()).all())
                zero &= bool((got[ln == 0] == 0).all())
                check(got.dtype == dtype, "decode kernel: wrong dtype")
            err = max(errs)
            what = (f"the serve launch ({serve_splits} ranks a cluster, "
                    f"{rows} rows a CTA: ctas_per_sm {cps})"
                    if splits is None else
                    f"{splits} ranks a cluster, {cta_rows} rows a CTA")
            if splits is None:
                print(f"[kernels] decode {name} {at}, {what}, "
                      f"{len(lengths)} lengths (0, page edges, the whole "
                      f"table, rank boundaries +-1: {lengths}), NaN past "
                      f"each length: max_abs_err {err:.3e} (tol {tol:g}); "
                      f"finite {finite}; length-0 slots zeros {zero}")
            else:
                print(f"[kernels] decode {name} {at}, {what}, "
                      f"{len(lengths)} lengths: max_abs_err {err:.3e}; "
                      f"finite {finite}; zeros {zero}")
            check(err <= tol, f"decode kernel disagrees ({what})")
            check(finite and zero, "decode kernel: a length-0 slot is not "
                  f"finite zeros, or a row past a length was read ({what})")
            if dtype == torch.bfloat16 and splits is None:
                worst["paged_decode"] = max(worst["paged_decode"], err)
        # prefill at mixed depths, a verify (Lq = 5) and the join shape,
        # through the op (the tuned launch) and at every rows a CTA
        for label, lq, offs in (
                ("prefill mixed q_offset", 40, [0, 16, 23, 100, 250, 0, 7,
                                                300]),
                ("verify Lq=5", 5, [12, 64, 99, 130, 255, 256, 400, 511]),
                ("join Lq=512", 512, [0] * 8)):
            kvl = [o + lq for o in offs]
            k, v, tbl = paged_inputs(torch, rng, b=8, depths=kvl,
                                     n_pages=512, p_max=64, dtype=dtype,
                                     hkv=hkv, d=d)
            q = torch.randn(8, lq, hq, d, generator=gen,
                            device=dev).to(dtype)
            off = torch.tensor(offs, dtype=torch.int32, device=dev)
            kv = torch.tensor(kvl, dtype=torch.int32, device=dev)
            want = ref.paged_prefill_attn_ref(q.float(), k[0].float(),
                                              v[0].float(), tbl, off, kv)
            fn = ops.paged_verify_attn if lq == 5 else ops.paged_prefill_attn
            errs = {}
            for br in (None,) + kernel.BLOCK_ROWS_CHOICES:
                got = fn(q, k[0], v[0], tbl, off, kv, block_rows=br)
                torch.cuda.synchronize()
                launched = kernel.last_launch["paged_prefill"]["block_rows"]
                errs["op" if br is None else br] = err = (
                    got.float() - want).abs().max().item()
                check(err <= tol and got.dtype == dtype,
                      f"prefill kernel disagrees ({label}, block_rows "
                      f"{launched})")
                if dtype == torch.bfloat16 and lq == 512 and br is None:
                    worst["paged_prefill"] = max(worst["paged_prefill"],
                                                 err)
                if br is None:
                    op_rows = launched
            print(f"[kernels] prefill {name} {at} {label}: max_abs_err "
                  f"through the op ({op_rows} rows a CTA) "
                  f"{errs['op']:.3e}, at 16/32/64 rows a CTA "
                  + "/".join(f"{errs[b]:.3e}"
                             for b in kernel.BLOCK_ROWS_CHOICES)
                  + f" (tol {tol:g})")
    # non-joining rows of a join: all-sentinel tables must not fault
    k, v, tbl = paged_inputs(torch, rng, b=2, depths=[64, 0], n_pages=8,
                             p_max=4, dtype=torch.bfloat16, hkv=hkv, d=d)
    q = torch.randn(2, 64, hq, d, generator=gen,
                    device=dev).to(torch.bfloat16)
    z = torch.zeros(2, dtype=torch.int32, device=dev)
    out = ops.paged_prefill_attn(q, k[0], v[0], tbl, z, z + 64)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()),
          "prefill kernel: non-finite output on an all-sentinel row")
    print(f"[kernels] {at} all-sentinel rows: finite, no fault")
    return worst


def kernel_timings(torch, geo=(HQ, HKV, D), layers=24) -> dict:
    """Times at the main path's shapes, bfloat16: 8 slots, pools for
    ``layers`` layers walked one layer per call (as the model walks them),
    decode depths over the run's range, and the first join (8 prompts
    padded to 512 tokens), at the attention geometry ``geo``."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attn import kernel, ops, ref, split
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    dtype, name, b = torch.bfloat16, "bfloat16", 8
    hq, hkv, d = geo
    item = 2
    out = {}

    lengths = [int(x) for x in rng.integers(65, 577, size=b)]
    k, v, tbl = paged_inputs(torch, rng, b=b, depths=lengths, n_pages=512,
                             p_max=64, dtype=dtype, layers=layers,
                             hkv=hkv, d=d)
    ctbl = ops._clamp_table(tbl, k.shape[1])
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kg, vg, mask = sdpa_inputs(torch, k[0], v[0], tbl,
                               (ln - 1)[:, None], ln)
    q4 = q[:, :, None]
    live = sum(lengths)
    nbytes = (2 * q.numel() * item + live * hkv * d * item * 2
              + tbl.numel() * 4 + b * 4)
    t_bound, by = bound(nbytes, 4.0 * hq * d * live, name)

    def decode(i):
        return kernel.paged_attn_cuda(q, k[i % layers], v[i % layers], ctbl,
                                      ln)

    def sdpa(i):
        return F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask,
                                              enable_gqa=True)
    kernel.last_launch["paged_decode"] = None
    out["paged_decode"] = {
        "ms": time_ms(decode, layers * 4),
        "graph_ms": graph_ms(decode, layers * 4),
        "host_us": host_us(decode),
        "plain_ms": time_ms(lambda i: ref.paged_attn_ref(
            q, k[i % layers], v[i % layers], tbl, ln).to(dtype), layers),
        "library_ms": time_ms(sdpa, layers * 4),
        "library_graph_ms": graph_ms(sdpa, layers * 4),
        "bound_ms": t_bound, "bound_by": by, "bytes": nbytes,
        "shape": f"B={b} Hq={hq} Hkv={hkv} D={d} ps={PS} lengths={lengths}"}
    # the cluster size the timed calls launched, held to the schedule's
    out["paged_decode"]["splits"] = launched = kernel.last_launch[
        "paged_decode"]["splits"]
    check(launched == split.split_count(b, hkv, hq // hkv,
                                        ctbl.shape[1] * PS,
                                        sm_count(dev)),
          f"paged_decode timing: launched {launched} ranks a cluster, not "
          "the schedule's count")

    lq = 512
    k, v, tbl = paged_inputs(torch, rng, b=b, depths=[lq] * b, n_pages=512,
                             p_max=64, dtype=dtype, layers=layers,
                             hkv=hkv, d=d)
    ctbl = ops._clamp_table(tbl, k.shape[1])
    q = torch.randn(b, lq, hq, d, generator=gen, device=dev).to(dtype)
    off = torch.zeros(b, dtype=torch.int32, device=dev)
    kv = off + lq
    pos = off[:, None] + torch.arange(lq, device=dev)[None, :]
    kg, vg, mask = sdpa_inputs(torch, k[0], v[0], tbl, pos, kv)
    q4 = q.permute(0, 2, 1, 3).contiguous()
    visible = b * lq * (lq + 1) // 2
    nbytes = (2 * q.numel() * item + b * lq * hkv * d * item * 2
              + tbl.numel() * 4 + 2 * b * 4)
    t_bound, by = bound(nbytes, 4.0 * hq * d * visible, name)
    out["paged_prefill"] = {
        "ms": time_ms(lambda i: kernel.paged_prefill_attn_cuda(
            q, k[i % layers], v[i % layers], ctbl, off, kv), layers),
        "graph_ms": graph_ms(lambda i: kernel.paged_prefill_attn_cuda(
            q, k[i % layers], v[i % layers], ctbl, off, kv), layers),
        "plain_ms": time_ms(lambda i: ref.paged_prefill_attn_ref(
            q, k[i % layers], v[i % layers], tbl, off, kv), layers, reps=3),
        "library_ms": time_ms(lambda i: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, enable_gqa=True), layers),
        "library_graph_ms": graph_ms(lambda i: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, enable_gqa=True), layers),
        "bound_ms": t_bound, "bound_by": by, "flops": 4.0 * hq * d * visible,
        "shape": f"B={b} Lq={lq} q_offset=0 kv_len={lq} Hq={hq} Hkv={hkv} "
                 f"D={d} ps={PS}"}
    for kname, row in out.items():
        print(f"[timing] {kname} {name} ({row['shape']}): kernel_ms "
              f"{row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, "
              f"library_ms {row['library_ms']:.4f}, bound_ms "
              f"{row['bound_ms']:.4f} ({row['bound_by']})")
    print_device_times("paged_decode", name, out["paged_decode"])
    print(f"[timing] paged_prefill {name} device only: graph_ms "
          f"{out['paged_prefill']['graph_ms']:.4f}; SDPA library_graph_ms "
          f"{out['paged_prefill']['library_graph_ms']:.4f}")
    return out


def verify_timing(torch, layers=24) -> dict:
    """The speculative verify at the features phase's serve shape: qwen,
    bfloat16, 8 slots, Lq = k+1 = 5 query tokens at decode depths of
    320-600 (``paged_prefill_tc.cu``: 5 x 7 = 35 query rows a (slot, KV
    head), one CTA each).  Back-to-back calls and one CUDA graph of them,
    its bytes bound, the plain version, SDPA on the gathered pages, and
    the decode kernel at the same depths times 5 (the five tokens decoded
    one by one).  Keys ``verify_*`` of the paged_prefill row."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attn import kernel, ops, ref
    rng = np.random.default_rng(2)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    dtype, name, b, lq, item = torch.bfloat16, "bfloat16", 8, 5, 2
    offs = [int(x) for x in rng.integers(320, 601 - lq, size=b)]
    kvl = [o + lq for o in offs]
    k, v, tbl = paged_inputs(torch, rng, b=b, depths=kvl, n_pages=512,
                             p_max=64, dtype=dtype, layers=layers)
    ctbl = ops._clamp_table(tbl, k.shape[1])
    q = torch.randn(b, lq, HQ, D, generator=gen, device=dev).to(dtype)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    kv = torch.tensor(kvl, dtype=torch.int32, device=dev)
    pos = off[:, None] + torch.arange(lq, device=dev)[None, :]
    kg, vg, mask = sdpa_inputs(torch, k[0], v[0], tbl, pos, kv)
    q4 = q.permute(0, 2, 1, 3).contiguous()
    qd = q[:, -1].contiguous()
    visible = sum(o * lq + lq * (lq + 1) // 2 for o in offs)
    nbytes = (2 * q.numel() * item + sum(kvl) * HKV * D * item * 2
              + tbl.numel() * 4 + 2 * b * 4)
    t_bound, by = bound(nbytes, 4.0 * HQ * D * visible, name)

    def verify(i):
        return kernel.paged_prefill_attn_cuda(q, k[i % layers],
                                              v[i % layers], ctbl, off, kv)

    def sdpa(i):
        return F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask,
                                              enable_gqa=True)

    def decode(i):
        return kernel.paged_attn_cuda(qd, k[i % layers], v[i % layers],
                                      ctbl, kv)
    row = {"verify_ms": time_ms(verify, layers * 4),
           "verify_graph_ms": graph_ms(verify, layers * 4),
           "verify_plain_ms": time_ms(lambda i: ref.paged_prefill_attn_ref(
               q, k[i % layers], v[i % layers], tbl, off, kv), layers,
               reps=3),
           "verify_library_ms": time_ms(sdpa, layers * 4),
           "verify_library_graph_ms": graph_ms(sdpa, layers * 4),
           "verify_decode5_graph_ms": 5 * graph_ms(decode, layers * 4),
           "verify_bound_ms": t_bound, "verify_bound_by": by,
           "verify_bytes": nbytes}
    err = (verify(0).float() - ref.paged_prefill_attn_ref(
        q.float(), k[0].float(), v[0].float(), tbl, off, kv)).abs().max()
    check(float(err) <= TOL[name], "verify timing: the kernel disagrees")
    print(f"[timing] paged_prefill verify {name} (B={b} Lq={lq} Hq={HQ} "
          f"Hkv={HKV} D={D} ps={PS} q_offset={offs}): kernel_ms "
          f"{row['verify_ms']:.4f}, device graph_ms "
          f"{row['verify_graph_ms']:.4f} "
          f"({t_bound / row['verify_graph_ms']:.1%} of the {by} bound "
          f"{t_bound:.4f}), plain_ms {row['verify_plain_ms']:.4f}, SDPA "
          f"library_ms {row['verify_library_ms']:.4f} (device "
          f"{row['verify_library_graph_ms']:.4f}), paged_decode at the "
          f"same depths x 5 (device) {row['verify_decode5_graph_ms']:.4f}; "
          f"max_abs_err {float(err):.3e}; {SMI}")
    return row


def print_device_times(kname: str, dtype_name: str, row: dict) -> None:
    print(f"[timing] {kname} {dtype_name} device only: graph_ms "
          f"{row['graph_ms']:.4f} ({row['splits']} ranks a cluster, "
          f"{row['bound_ms'] / row['graph_ms']:.1%} of the bytes bound); "
          f"SDPA library_graph_ms {row['library_graph_ms']:.4f}; the "
          f"wrapper's host time {row['host_us']:.1f} us a call")


def stripe_checks(torch, geos=((HQ, HKV, D), (4, 1, 16), MOE_GEO,
                               *(geo for _, geo in FAMILIES.values()))
                  ) -> float:
    """The dense-stripe decode kernel against its plain version, at the
    (Hq, Hkv, D) geometries ``geos``: by default the full-width qwen (G =
    7, D = 64), reduced (G = 4, D = 16), full-width moonshot (G = 1, D =
    128) and the three dense families' (starcoder2 G 12, nemotron G 6,
    codeqwen 32 heads at G 1, all D 128), in both dtypes, over the whole
    stripe and under ``s_cap``; returns the largest error at D 64 in
    bfloat16 (the full-width qwen's, or the geometry given)."""
    from repro_torch.kernels.decode_attn import (decode_attn,
                                                 decode_attn_ref, kernel)
    from repro_torch.kernels.paged_attn import split
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    b, s = 8, 1025
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        tol = TOL[name]
        for hq, hkv, d in geos:
            for s_cap in (None, 512):
                cap = s if s_cap is None else s_cap
                splits = split.split_count(
                    b, hkv, hq // hkv, cap,
                    sm_count(torch.device("cuda", 0)))
                lengths = sorted({0, 1, 63, 64, 65, 300, 700, 1100}
                                 | set(split.boundary_lengths(splits, cap)))
                errs, finite, zero = [], True, True
                for i in range(0, len(lengths), b):
                    batch = (lengths[i:i + b] + lengths)[:b]
                    ln = torch.tensor(batch, dtype=torch.int32, device=dev)
                    q = torch.randn(b, hq, d, generator=gen,
                                    device=dev).to(dtype)
                    k, v = (torch.randn(b, s, hkv, d, generator=gen,
                                        device=dev).to(dtype) for _ in "kv")
                    k[:, cap:] = float("nan")    # never read under s_cap
                    v[:, cap:] = float("nan")
                    got = decode_attn(q, k, v, ln, s_cap=s_cap)
                    check(kernel.last_splits["decode_attn"] == splits,
                          "decode_attn kernel: not the batch's split count")
                    want = decode_attn_ref(q.float(), k[:, :cap].float(),
                                           v[:, :cap].float(), ln)
                    torch.cuda.synchronize()
                    errs.append((got.float() - want).abs().max().item())
                    finite &= bool(torch.isfinite(got.float()).all())
                    zero &= bool((got[ln == 0] == 0).all())
                    check(got.dtype == dtype, "decode_attn: wrong dtype")
                err = max(errs)
                print(f"[kernels] decode_attn {name} G={hq // hkv} D={d} "
                      f"s_cap={cap} of {s} rows, {splits} ranks a cluster, "
                      f"{len(lengths)} lengths (0, 1, above the rows read, "
                      f"rank boundaries +-1): max_abs_err {err:.3e} (tol "
                      f"{tol:g}); finite {finite}; length-0 slots zeros "
                      f"{zero}")
                check(err <= tol, "decode_attn kernel disagrees")
                check(finite and zero, "decode_attn kernel: a length-0 "
                      "slot is not finite zeros, or a row past s_cap was "
                      "read")
                if dtype == torch.bfloat16 and d == D:
                    worst = max(worst, err)
    return worst


def stripe_timing(torch, geo=(HQ, HKV, D), layers=24) -> dict:
    """Time at the dense decode step's shapes, bfloat16: 8 slots at
    depths over the serve run's range, stripes of max_len + 1 = 1025 rows
    for ``layers`` layers walked one layer per call, ``s_cap`` the
    scheduler's row bucket for an 8-step segment, at the geometry
    ``geo``."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import decode_attn_ref, kernel
    from repro_torch.kernels.paged_attn import split
    from repro_torch.serve.scheduler import _pow2_bucket
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    dtype, name, b, max_len, item = torch.bfloat16, "bfloat16", 8, 1024, 2
    hq, hkv, d = geo
    lengths = [int(x) for x in rng.integers(65, 577, size=b)]
    cap = min(_pow2_bucket(max(lengths) + 8, hi=max_len), max_len)
    shape = (layers, b, max_len + 1, hkv, d)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q4 = q[:, :, None]
    kt = [k[i, :, :cap].transpose(1, 2) for i in range(layers)]
    vt = [v[i, :, :cap].transpose(1, 2) for i in range(layers)]
    mask = (torch.arange(cap, device=dev)[None, :]
            < ln[:, None])[:, None, None, :]
    live = sum(min(n, cap) for n in lengths)
    nbytes = 2 * q.numel() * item + live * hkv * d * item * 2 + b * 4
    t_bound, by = bound(nbytes, 4.0 * hq * d * live, name)

    def decode(i):
        return kernel.decode_attn_cuda(q, k[i % layers], v[i % layers], ln,
                                       cap)

    def sdpa(i):
        return F.scaled_dot_product_attention(
            q4, kt[i % layers], vt[i % layers], attn_mask=mask,
            enable_gqa=True)
    kernel.last_splits["decode_attn"] = None
    row = {
        "ms": time_ms(decode, layers * 4),
        "graph_ms": graph_ms(decode, layers * 4),
        "host_us": host_us(decode),
        "plain_ms": time_ms(lambda i: decode_attn_ref(
            q, k[i % layers, :, :cap], v[i % layers, :, :cap],
            ln).to(dtype), layers),
        "library_ms": time_ms(sdpa, layers * 4),
        "library_graph_ms": graph_ms(sdpa, layers * 4),
        "bound_ms": t_bound, "bound_by": by, "bytes": nbytes,
        "shape": f"B={b} Hq={hq} Hkv={hkv} D={d} S={max_len + 1} "
                 f"s_cap={cap} lengths={lengths}"}
    # the cluster size the timed calls launched, held to the schedule's
    row["splits"] = launched = kernel.last_splits["decode_attn"]
    check(launched == split.split_count(b, hkv, hq // hkv, cap,
                                        sm_count(dev)),
          f"decode_attn timing: launched {launched} ranks a cluster, not "
          "the schedule's count")
    print(f"[timing] decode_attn {name} ({row['shape']}): kernel_ms "
          f"{row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, library_ms "
          f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} "
          f"({row['bound_by']})")
    print_device_times("decode_attn", name, row)
    return row


# ---------------------------------------------------------------------------
# the grouped expert GEMM, at full-width moonshot's expert shapes
# ---------------------------------------------------------------------------

def routed_counts(torch, tokens: int, seed: int, arch: str = MOE_ARCH):
    """(counts [E] int32, capacity) of one MoE call over ``tokens`` tokens
    at full-width ``arch``: the port's route and rank dispatch on a seeded
    router (N(0, 0.02), as the init draws it) and seeded activations of
    unit RMS (what the block's norm hands the router)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    router = {"w": 0.02 * torch.randn(cfg.d_model, cfg.moe.n_experts,
                                      generator=gen, device="cuda")}
    x = torch.randn(tokens, cfg.d_model, generator=gen, device="cuda")
    _, ids, _ = moe.route({"router": router}, x, cfg)
    cap = moe.capacity(cfg, tokens)
    return moe.dispatch(ids, cfg.moe.n_experts, cap)[2], cap


def group_inputs(torch, rng, e, c, d, f, counts, dtype):
    """xe [E, C, D] with NaN in the padding rows (rows at or past each
    count), w [E, D, F] of std 1/sqrt(D) with NaN in the empty experts,
    and the float64 product of the live rows with its magnitudes."""
    import numpy as np
    cnt = torch.as_tensor(np.asarray(counts, np.int32), device="cuda")
    xe = torch.from_numpy(rng.standard_normal((e, c, d)).astype(
        np.float32)).cuda().to(dtype)
    w = (torch.from_numpy(rng.standard_normal((e, d, f)).astype(
        np.float32)).cuda() / math.sqrt(d)).to(dtype)
    live = torch.arange(c, device="cuda")[None, :, None] < cnt[:, None, None]
    x64, w64 = (xe * live).double(), w.double()
    want, mag = torch.bmm(x64, w64), torch.bmm(x64.abs(), w64.abs())
    xe = torch.where(live, xe, torch.full_like(xe, float("nan")))
    w[cnt == 0] = float("nan")
    return xe, w, cnt, live, want, mag


def group_gemm_checks(torch) -> float:
    """The kernel against the float64 product of the same values:
    ``test_kernels_moe.py``'s sweep, empty and full experts, a ragged C,
    and both full-width shapes (decode C 1 and a 4,096-token join's C 480,
    gate/up D 2048 -> F 1408 and down 1408 -> 2048) with counts from a
    seeded routing; both dtypes within the float32 summation bound (the
    bfloat16 products are exact and summed in float32); the rows past each
    count exactly zero though the padding holds NaN.  A second launch with
    the kernel's tile counters gives the same bits and must count on the
    card the tiles that the counts predict.  Rows of D and F that are not
    whole 16 bytes are refused.  Returns the largest bfloat16 error at the
    full-width decode shape."""
    import numpy as np
    from repro_torch.kernels import moe_group_gemm as mg
    rng = np.random.default_rng(6)
    dec, dec_cap = routed_counts(torch, 8, SEED)
    pre, pre_cap = routed_counts(torch, 4096, SEED + 1)
    dec, pre = dec.cpu().numpy(), pre.cpu().numpy()
    cases = [(f"sweep {s}", *s, rng.integers(0, s[1] + 1, size=s[0]))
             for s in ((2, 128, 64, 64), (8, 256, 128, 96), (4, 64, 32, 256))]
    cases += [("all-empty", 4, 64, 32, 64, np.zeros(4)),
              ("all-full", 4, 64, 32, 64, np.full(4, 64)),
              ("ragged C, counts past C", 6, 100, 48, 80,
               [100, 37, 0, 64, 103, 1]),
              ("full-width decode gate/up", 64, dec_cap, 2048, 1408, dec),
              ("full-width decode down", 64, dec_cap, 1408, 2048, dec),
              ("full-width join gate/up", 64, pre_cap, 2048, 1408, pre),
              ("full-width join down", 64, pre_cap, 1408, 2048, pre)]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for label, e, c, d, f, counts in cases:
            xe, w, cnt, live, want, mag = group_inputs(torch, rng, e, c, d,
                                                       f, counts, dtype)
            got = mg.group_gemm(xe, w, cnt)
            tiles = torch.zeros(2, dtype=torch.int32, device="cuda")
            again = mg.kernel.group_gemm_cuda(xe, w, cnt, tiles=tiles)
            torch.cuda.synchronize()
            zeros = bool((got[~live.expand(e, c, f)] == 0).all())
            ok, err, ratio = summed_within(got, want, mag, d)
            if name == "bfloat16" and label == "full-width decode gate/up":
                worst = err
            total, skipped = tiles.tolist()
            print(f"[kernels] group_gemm {name} {label} (E={e} C={c} D={d} "
                  f"F={f}, {int(cnt.clamp(0, c).sum())} live rows): "
                  f"max_abs_err {err:.3e} ({ratio:.3f} of the float32 "
                  f"bound); rows past the counts exactly 0: {zeros}; tiles "
                  f"skipped (counted on the card) {skipped}/{total}")
            check(ok and zeros and bool(torch.isfinite(got).all()),
                  f"group_gemm disagrees ({name}, {label})")
            check(torch.equal(again, got),
                  f"group_gemm: a second launch differs ({name}, {label})")
            check((total, skipped) == mg.kernel.tile_counts(cnt, c, f,
                                                            dtype),
                  f"group_gemm: tiles counted on the card are not those the "
                  f"counts predict ({name}, {label})")
    try:
        mg.group_gemm(torch.zeros(3, 40, 37, device="cuda"),
                      torch.zeros(3, 37, 53, device="cuda"),
                      torch.zeros(3, dtype=torch.int32, device="cuda"))
    except ValueError as err:
        print(f"[kernels] group_gemm refuses rows of D 37, F 53: {err}")
    else:
        check(False, "group_gemm took rows that are not whole 16 bytes")
    return worst


def group_gemm_timing(torch) -> dict:
    """Times at full-width moonshot's expert shapes (64 experts, bfloat16),
    counts from a seeded routing: the decode step's gate/up call (batch 8,
    C 1, D 2048 -> F 1408) on the row, a 4,096-token join's gate/up call
    (C 480) in its ``prefill_*`` keys and the join's down projection (D
    1408 -> F 2048) in its ``down_*`` keys.  The bound counts the live
    experts' weights, the live rows in and every output row out; the
    library call is one ``torch.bmm`` over the padded slabs, which reads
    every expert's weights.  The tiles and tiles skipped are the kernel's
    own count, on the card, of its first (checked) launch."""
    import numpy as np
    from repro_torch.kernels import moe_group_gemm as mg
    e, item = 64, 2
    rng = np.random.default_rng(7)
    weights = {}
    rows = {}
    for label, tokens, seed, d, f in (("decode", 8, SEED, 2048, 1408),
                                      ("prefill", 4096, SEED + 1, 2048, 1408),
                                      ("down", 4096, SEED + 1, 1408, 2048)):
        if (d, f) not in weights:
            weights[d, f] = (torch.from_numpy(rng.standard_normal(
                (e, d, f)).astype(np.float32)).cuda()
                / math.sqrt(d)).to(torch.bfloat16)
        w = weights[d, f]
        cnt, c = routed_counts(torch, tokens, seed)
        xe = torch.from_numpy(rng.standard_normal((e, c, d)).astype(
            np.float32)).cuda().to(torch.bfloat16)
        live = torch.arange(c, device="cuda")[None, :, None] < cnt[:, None,
                                                                   None]
        xe = xe * live
        n_rows, n_live = int(cnt.sum()), int((cnt > 0).sum())
        nbytes = (n_live * d * f * item + n_rows * d * item + e * c * f * 4
                  + e * 4)
        flops = 2.0 * n_rows * d * f
        t_bound, by = bound(nbytes, flops, "bfloat16")
        tiles = torch.zeros(2, dtype=torch.int32, device="cuda")
        got = mg.kernel.group_gemm_cuda(xe, w, cnt, tiles=tiles)
        err = float((got.double() - torch.bmm(xe.double(), w.double())
                     ).abs().max())
        total, skipped = tiles.tolist()
        calls = 20 if c == 1 else 5
        rows[label] = {
            "ms": time_ms(lambda i: mg.kernel.group_gemm_cuda(
                xe, w, cnt), calls),
            "plain_ms": time_ms(lambda i: mg.group_gemm_ref(
                xe, w, cnt), 3, reps=3),
            "library_ms": time_ms(lambda i: torch.bmm(xe, w), calls),
            "bound_ms": t_bound, "bound_by": by, "max_abs_err": err,
            "flops": flops, "tiles_skipped": skipped, "tiles": total,
            "shape": f"E={e} C={c} D={d} F={f} bf16, {n_rows} live rows in "
                     f"{n_live} live experts"}
        r = rows[label]
        print(f"[timing] group_gemm {label} ({r['shape']}): kernel_ms "
              f"{r['ms']:.4f}, plain_ms {r['plain_ms']:.4f}, library_ms "
              f"(torch.bmm, padded) {r['library_ms']:.4f}, bound_ms "
              f"{t_bound:.4f} ({by}), tiles skipped (counted on the card) "
              f"{skipped}/{total}, "
              f"max_abs_err vs float64 {err:.3e}")
    row = dict(rows["decode"])
    for label in ("prefill", "down"):
        row.update({f"{label}_{k}": rows[label][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "flops",
            "tiles_skipped", "tiles")})
    return row


DEEPSEEK_GEMMS = (("decode gate/up", 8, SEED, 7168, 2048),
                  ("decode down", 8, SEED, 2048, 7168),
                  ("join gate/up", 4096, SEED + 1, 7168, 2048),
                  ("join down", 4096, SEED + 1, 2048, 7168))


def deepseek_group_inputs(torch, tokens, seed, d, f, dtype):
    """Full-width deepseek-v3's expert slabs, drawn on the card (E 256: the
    weights are 3.8 G values): counts from a seeded routing over 256
    experts top-8, xe [E, C, D] with NaN in the padding rows, w [E, D, F]
    of std 1/sqrt(D) with NaN in the empty experts."""
    cnt, c = routed_counts(torch, tokens, seed, MLA_ARCH)
    e = cnt.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(seed + d)
    xe = torch.randn(e, c, d, generator=gen, device="cuda").to(dtype)
    w = torch.empty(e, d, f, device="cuda", dtype=dtype)
    for i in range(e):                 # one expert at a time: no float32
        w[i] = torch.randn(d, f, generator=gen,          # copy of all 256
                           device="cuda") / math.sqrt(d)
    live = torch.arange(c, device="cuda")[None, :, None] < cnt[:, None, None]
    xe = torch.where(live, xe, torch.full_like(xe, float("nan")))
    w[cnt == 0] = float("nan")
    return xe, w, cnt, live


def deepseek_group_gemm_checks(torch) -> float:
    """The grouped GEMM at full-width deepseek-v3's expert shapes (E 256,
    D 7168, F 2048, top-8), both dtypes: decode (8 tokens, C 1) and a
    4,096-token join (C 160), gate/up and down, counts from a seeded
    routing; within the float32 summation bound of the float64 product
    (computed 32 experts at a time), the rows past each count exactly
    zero though the padding holds NaN, a second launch bit-equal, and the
    tiles skipped counted on the card as the counts predict.  Returns the
    largest bfloat16 error at the decode gate/up shape."""
    from repro_torch.kernels import moe_group_gemm as mg
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for label, tokens, seed, d, f in DEEPSEEK_GEMMS:
            xe, w, cnt, live = deepseek_group_inputs(torch, tokens, seed, d,
                                                     f, dtype)
            e, c = xe.shape[:2]
            got = mg.group_gemm(xe, w, cnt)
            tiles = torch.zeros(2, dtype=torch.int32, device="cuda")
            again = mg.kernel.group_gemm_cuda(xe, w, cnt, tiles=tiles)
            torch.cuda.synchronize()
            zeros = bool((got[~live.expand(e, c, f)] == 0).all())
            ok, err, ratio = True, 0.0, 0.0
            x_live = torch.where(live, xe, torch.zeros_like(xe))
            for lo in range(0, e, 32):
                x64 = x_live[lo:lo + 32].double()
                w64 = torch.nan_to_num(w[lo:lo + 32].double())
                part = summed_within(got[lo:lo + 32], torch.bmm(x64, w64),
                                     torch.bmm(x64.abs(), w64.abs()), d)
                ok, err, ratio = (ok and part[0], max(err, part[1]),
                                  max(ratio, part[2]))
                del x64, w64
            if name == "bfloat16" and label == "decode gate/up":
                worst = err
            total, skipped = tiles.tolist()
            print(f"[kernels] group_gemm {name} deepseek {label} (E={e} "
                  f"C={c} D={d} F={f}, {int(cnt.clamp(0, c).sum())} live "
                  f"rows in {int((cnt > 0).sum())} live experts): "
                  f"max_abs_err {err:.3e} ({ratio:.3f} of the float32 "
                  f"bound); rows past the counts exactly 0: {zeros}; tiles "
                  f"skipped (counted on the card) {skipped}/{total}")
            check(ok and zeros and bool(torch.isfinite(got).all()),
                  f"group_gemm disagrees ({name}, deepseek {label})")
            check(torch.equal(again, got), f"group_gemm: a second launch "
                  f"differs ({name}, deepseek {label})")
            check((total, skipped) == mg.kernel.tile_counts(cnt, c, f,
                                                            dtype),
                  f"group_gemm: tiles counted on the card are not those the "
                  f"counts predict ({name}, deepseek {label})")
            del xe, w, got, again, x_live
            torch.cuda.empty_cache()
    return worst


def deepseek_group_gemm_timing(torch) -> dict:
    """Times at full-width deepseek-v3's expert shapes (256 experts,
    bfloat16), counts from a seeded routing: the decode step's gate/up
    call (8 tokens, C 1, D 7168 -> F 2048) in the ``ds_*`` keys, a
    4,096-token join's gate/up (C 160) in ``ds_prefill_*`` and its down
    projection (D 2048 -> F 7168) in ``ds_down_*``.  Bound, library call
    (one ``torch.bmm`` over the padded slabs, reading every expert) and
    tiles as in :func:`group_gemm_timing`."""
    from repro_torch.kernels import moe_group_gemm as mg
    item, row = 2, {}
    for key, (label, tokens, seed, d, f) in zip(
            ("ds_", "ds_prefill_", "ds_down_"),
            (DEEPSEEK_GEMMS[0], DEEPSEEK_GEMMS[2], DEEPSEEK_GEMMS[3])):
        xe, w, cnt, live = deepseek_group_inputs(torch, tokens, seed, d, f,
                                                 torch.bfloat16)
        xe = torch.where(live, xe, torch.zeros_like(xe))
        w = torch.nan_to_num(w)
        e, c = xe.shape[:2]
        n_rows, n_live = int(cnt.sum()), int((cnt > 0).sum())
        nbytes = (n_live * d * f * item + n_rows * d * item + e * c * f * 4
                  + e * 4)
        flops = 2.0 * n_rows * d * f
        t_bound, by = bound(nbytes, flops, "bfloat16")
        tiles = torch.zeros(2, dtype=torch.int32, device="cuda")
        mg.kernel.group_gemm_cuda(xe, w, cnt, tiles=tiles)
        total, skipped = tiles.tolist()
        calls = 20 if c == 1 else 5
        part = {"ms": time_ms(lambda i: mg.kernel.group_gemm_cuda(
                    xe, w, cnt), calls),
                "plain_ms": time_ms(lambda i: mg.group_gemm_ref(
                    xe, w, cnt), 2, reps=2),
                "library_ms": time_ms(lambda i: torch.bmm(xe, w), calls),
                "bound_ms": t_bound, "bound_by": by, "flops": flops,
                "tiles_skipped": skipped, "tiles": total}
        row.update({key + k: v for k, v in part.items()})
        print(f"[timing] group_gemm deepseek {label} (E={e} C={c} D={d} "
              f"F={f} bf16, {n_rows} live rows in {n_live} live experts): "
              f"kernel_ms {part['ms']:.4f}, plain_ms {part['plain_ms']:.4f}, "
              f"library_ms (torch.bmm, padded) {part['library_ms']:.4f}, "
              f"bound_ms {t_bound:.4f} ({by}), {flops / part['ms'] / 1e9:.1f}"
              f" TFLOP/s, {t_bound / part['ms']:.1%} of its bound, tiles "
              f"skipped (counted on the card) {skipped}/{total}; {SMI}")
        del xe, w
        torch.cuda.empty_cache()
    return row


def redesign_line(timings: dict) -> None:
    """The redesigned kernels' achieved rate and share of their bound."""
    parts = []
    for label, name, key in (
            ("paged_prefill qwen join", "paged_prefill", ""),
            ("paged_prefill moonshot join (D 128)", "paged_prefill",
             "d128_"),
            ("group_gemm join gate/up", "group_gemm", "prefill_"),
            ("group_gemm join down", "group_gemm", "down_"),
            ("ssgemm_masked N 16 make_skinny", "ssgemm_masked", "n16_"),
            ("ssgemm_compact N 16 clustered", "ssgemm_compact", "n16_")):
        row = timings[name]
        ms = row[key + "ms"]
        parts.append(f"{label} {ms:.4f} ms, "
                     f"{row[key + 'flops'] / ms / 1e9:.1f} TFLOP/s, "
                     f"{row[key + 'bound_ms'] / ms:.1%} of its bound")
    print("[timing] redesigned kernels (bf16): " + "; ".join(parts))
    parts = []
    for label, name, key in (
            ("paged_decode qwen", "paged_decode", ""),
            ("paged_decode moonshot (D 128)", "paged_decode", "d128_"),
            ("decode_attn qwen", "decode_attn", ""),
            ("decode_attn moonshot (D 128)", "decode_attn", "d128_")):
        row = timings[name]
        ms, lib = row[key + "graph_ms"], row[key + "library_graph_ms"]
        parts.append(f"{label} {ms:.4f} ms ({row[key + 'splits']} ranks "
                     f"a cluster), {row[key + 'bytes'] / ms / 1e6:.1f} GB/s, "
                     f"{row[key + 'bound_ms'] / ms:.1%} of its bound; SDPA "
                     f"{lib:.4f} ms ({lib / ms:.2f}x the kernel's time)")
    print("[timing] redesigned decode kernels (bf16, device time from a "
          "CUDA graph): " + "; ".join(parts))
    parts = []
    for label, name, key, lib_name in (
            ("wavesim_volume float32", "wavesim_volume", "", "torch.matmul"),
            ("wavesim_volume bf16", "wavesim_volume", "bf16_",
             "torch.matmul"),
            ("vector_sum float16 64 Mi", "vector_sum", "", "torch.add")):
        row = timings[name]
        ms, lib = row[key + "graph_ms"], row[key + "library_graph_ms"]
        gbs = row[key + "bytes"] / ms / 1e6
        parts.append(f"{label} {ms:.4f} ms, {gbs:.1f} GB/s, "
                     f"{row[key + 'bound_ms'] / ms:.1%} of its bound; "
                     f"{lib_name} {lib:.4f} ms ({lib / ms:.2f}x the kernel's "
                     f"time)")
    print("[timing] redesigned primitives (device time from a CUDA graph): "
          + "; ".join(parts))


# ---------------------------------------------------------------------------
# the paper's primitives: skinny GEMM (masked, compact) and push scatter
# ---------------------------------------------------------------------------

def gamma(n_terms):
    """Worst-case relative error of a float32 sum of ``n_terms`` terms in
    any order, each term rounded at most once: n u / (1 - n u) (Higham's
    gamma_n; n u to first order).  Works on floats and tensors."""
    nu = n_terms * UNIT_ROUNDOFF
    return nu / (1 - nu)


def summed_within(got, want64, abs64, n_terms) -> tuple[bool, float, float]:
    """Per output, |got - want| <= gamma(n) x sum |terms| (``want64`` and
    ``abs64`` in float64 from the same inputs).  Returns (ok, max abs error,
    largest error as a share of its bound)."""
    err = (got.double() - want64).abs()
    lim = gamma(n_terms) * abs64
    ratio = float((err / lim.clamp_min(1e-300)).max()) if err.numel() else 0.0
    return bool((err <= lim).all()), float(err.max()), ratio


def skinny_inputs(torch, rng, m, k, n, density, dtype, bk):
    """A [M, K] and B [K, N] on the card; B's k-blocks of ``bk`` rows dead
    with probability 1 - density (one kept live at a density in (0, 1))."""
    import numpy as np
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = rng.standard_normal((k, n)).astype(np.float32)
    nk = -(-k // bk)
    live = rng.random(nk) < density
    if 0 < density < 1 and not live.any():
        live[nk // 2] = True
    b[~np.repeat(live, bk)[:k]] = 0.0
    return (a.cuda().to(dtype), torch.from_numpy(b).cuda().to(dtype))


def ssgemm_checks(torch) -> None:
    """Both walks against their plain versions on the card (float64 on the
    same values, worst-case float32 bound), at ragged and aligned shapes,
    N 1-16, densities 0 / 0.05 / 1, in bfloat16 and float32, on both
    routes; the compact op at budgets 1, the live count and every block;
    then A poisoned with NaN in every block a walk skips."""
    import numpy as np
    from repro_torch.kernels import ss_gemm as sg
    rng = np.random.default_rng(3)
    shapes = [(300, 300, 128),      # ragged M and K (the JAX NaN case)
              (77, 520, 256),       # ragged M, ragged last block
              (1000, 4096, 256)]    # aligned, the paper's K
    n_checks = overflows = 0
    worst = 0.0
    sg.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        for m, k, bk in shapes:
            for n in (1, 2, 3, 4, 8, 9, 15, 16):
                for density in (0.0, 0.05, 1.0):
                    a, b = skinny_inputs(torch, rng, m, k, n, density, dtype,
                                         bk)
                    a64, b64 = a.double(), b.double()
                    full, full_abs = a64 @ b64, a64.abs() @ b64.abs()
                    mask = sg.block_occupancy(b, bk)
                    nk, live = mask.shape[0], int(mask.sum())
                    got = sg.kernel.ssgemm_masked_cuda(a, b, mask, bk)
                    want = sg.ssgemm_masked_ref(a64, b64, mask, bk)
                    bnd = sg.ssgemm_masked_ref(a64.abs(), b64.abs(), mask, bk)
                    results = [("masked kernel", summed_within(got, want, bnd,
                                                               k))]
                    # the list walk on its own arguments, out of order
                    idx = torch.arange(nk - 1, -1, -2, dtype=torch.int32,
                                       device="cuda")
                    nl = torch.tensor([max(idx.numel() - 1, 0)],
                                      dtype=torch.int32, device="cuda")
                    got = sg.kernel.ssgemm_compact_cuda(a, b, idx, nl, bk)
                    want = sg.ssgemm_compact_ref(a64, b64, idx, nl, bk)
                    bnd = sg.ssgemm_compact_ref(a64.abs(), b64.abs(), idx,
                                                nl, bk)
                    results.append(("compact kernel",
                                    summed_within(got, want, bnd, k)))
                    results.append(("masked op", summed_within(
                        sg.ssgemm_masked(a, b, bk=bk), full, full_abs, k)))
                    for budget in sorted({1, max(live, 1), nk}):
                        overflows += budget < live
                        results.append((f"compact op budget {budget}",
                                        summed_within(sg.ssgemm_compact(
                                            a, b, budget=budget, bk=bk),
                                            full, full_abs, k)))
                    torch.cuda.synchronize()
                    for label, (ok, err, ratio) in results:
                        n_checks += 1
                        worst = max(worst, ratio)
                        check(ok, f"ssgemm {label} outside the float32 bound "
                              f"({dtype}, M={m} K={k} N={n} bk={bk} "
                              f"density {density}): err {err:.3e}, "
                              f"{ratio:.2f} of the bound")
    check(overflows > 0, "no compact check took the overflow guard")
    print(f"[kernels] ssgemm masked/compact, bfloat16 and float32, "
          f"M x K x bk {shapes}, N 1-16, density 0/0.05/1: {n_checks} "
          f"checks within the float32 summation bound (largest error "
          f"{worst:.3f} of its bound); {overflows} compact runs took the "
          f"overflow guard; routes {sg.route_counts}")
    check(min(sg.route_counts.values()) > 0, "an ss-gemm route never ran")
    ssgemm_poison_checks(torch)


def ssgemm_poison_checks(torch) -> None:
    """A's columns hold NaN in every block a walk skips (for the list walk
    also the live blocks listed past n_live): a kernel that loaded them and
    multiplied by B's zeros would return NaN.  Both routes, both walks and
    both ops, finite and within the float32 bound."""
    import numpy as np
    from repro_torch.kernels import ss_gemm as sg
    rng = np.random.default_rng(5)
    sg.reset_launch_counts()
    worst, n_checks = 0.0, 0
    for dtype in (torch.bfloat16, torch.float32):
        for m, k, bk in ((1000, 4096, 256), (77, 520, 256)):
            for n in (4, 16):
                a, b = skinny_inputs(torch, rng, m, k, n, 1.0, dtype, bk)
                nk = -(-k // bk)
                for kb in range(1, nk - 1, 2):    # odd blocks dead
                    b[kb * bk:(kb + 1) * bk] = 0
                mask = sg.block_occupancy(b, bk)
                live = torch.nonzero(mask).reshape(-1)
                a64, b64 = a.double(), b.double()
                full, full_abs = a64 @ b64, a64.abs() @ b64.abs()

                def poisoned(walked):
                    cols = torch.zeros(k, dtype=torch.bool, device="cuda")
                    for kb in walked:
                        cols[kb * bk:(kb + 1) * bk] = True
                    return a.masked_fill(~cols, float("nan"))
                a_mask = poisoned(live.tolist())
                idx = live.flip(0).to(torch.int32)      # the last past n_live
                nl = torch.tensor([idx.numel() - 1], dtype=torch.int32,
                                  device="cuda")
                runs = [("masked kernel", sg.kernel.ssgemm_masked_cuda(
                            a_mask, b, mask, bk), full, full_abs),
                        ("masked op", sg.ssgemm_masked(a_mask, b, bk=bk),
                         full, full_abs),
                        ("compact op", sg.ssgemm_compact(
                            a_mask, b, budget=live.numel(), bk=bk), full,
                         full_abs),
                        ("compact kernel", sg.kernel.ssgemm_compact_cuda(
                            poisoned(idx[:-1].tolist()), b, idx, nl, bk),
                         sg.ssgemm_compact_ref(a64, b64, idx, nl, bk),
                         sg.ssgemm_compact_ref(a64.abs(), b64.abs(), idx,
                                               nl, bk))]
                torch.cuda.synchronize()
                for label, got, want, bnd in runs:
                    ok, err, ratio = summed_within(got, want, bnd, k)
                    n_checks += 1
                    worst = max(worst, ratio)
                    check(ok and bool(torch.isfinite(got).all()),
                          f"ssgemm {label} read a skipped block ({dtype}, "
                          f"M={m} K={k} N={n}): err {err:.3e}")
    print(f"[kernels] ssgemm NaN in every skipped block of A: {n_checks} "
          f"checks finite and within the float32 bound (largest error "
          f"{worst:.3f} of its bound); routes {sg.route_counts}")
    check(min(sg.route_counts.values()) > 0,
          "an ss-gemm route missed the NaN check")


def push_checks(torch) -> None:
    """The push-scatter kernel against its plain version on the card: the
    cold values exactly, each hot slot within the float32 summation bound
    of its own update count; then the op against the float64 oracle."""
    import numpy as np
    from repro_torch.kernels import push_scatter as ps
    rng = np.random.default_rng(4)
    cases = [("every update hot", 256, 100_003, 256, "hot"),
             ("every update cold", 4096, 4096, 1024, "cold"),
             ("hot == n < 1024", 700, 50_000, 700, "zipf"),
             ("hot 1024", 1_000_000, 1_000_000, 1024, "zipf"),
             ("U a multiple of no tile", 200_000, 100_003, 1024, "zipf")]
    for label, n, u, hot, kind in cases:
        if kind == "zipf":
            pop = 1.0 / np.arange(1, n + 1) ** 1.1
            dst = rng.choice(n, size=u, p=pop / pop.sum())
        elif kind == "cold":
            dst = rng.permutation(n)[:u]
        else:
            dst = rng.integers(0, n, size=u)
        dst = torch.from_numpy(dst.astype(np.int64)).cuda()
        contrib = torch.from_numpy(
            rng.standard_normal(u).astype(np.float32)).cuda()
        values = torch.from_numpy(
            rng.standard_normal(n).astype(np.float32)).cuda()
        slots = ps.hot_set(dst, n, hot)[dst]
        if kind == "cold":
            slots = torch.full_like(slots, -1)
        hot_acc, cold = ps.kernel.push_scatter_cuda(slots, contrib, hot)
        want, want_cold = ps.push_scatter_kernel_ref(slots, contrib.double(),
                                                     hot)
        bnd, _ = ps.push_scatter_kernel_ref(slots, contrib.double().abs(),
                                            hot)
        count, _ = ps.push_scatter_kernel_ref(slots, torch.ones_like(
            contrib), hot)
        ok, err, ratio = summed_within(hot_acc, want, bnd, count.double())
        exact = bool(torch.equal(cold.double(), want_cold))
        got = ps.push_scatter(values, contrib, dst, hot=hot)
        terms = 1 + torch.bincount(dst, minlength=n).double()
        op_ok, op_err, op_ratio = summed_within(
            got, ps.push_scatter_ref(values.double(), contrib.double(), dst),
            ps.push_scatter_ref(values.double().abs(),
                                contrib.double().abs(), dst), terms)
        share = float((slots >= 0).float().mean())
        torch.cuda.synchronize()
        print(f"[kernels] push_scatter {label} (n={n} U={u} hot={hot}, hot "
              f"share {share:.1%}): hot_acc max_abs_err {err:.3e} "
              f"({ratio:.3f} of the bound), cold values exact {exact}; op "
              f"max_abs_err {op_err:.3e} ({op_ratio:.3f} of the bound)")
        check(ok and exact and op_ok, f"push_scatter disagrees ({label})")
        check(kind != "hot" or bool((cold == 0).all()),
              "push_scatter: a hot update left a cold value")
        check(kind != "cold" or bool((hot_acc == 0).all()),
              "push_scatter: a cold update reached the hot accumulator")


def clustered_skinny(rng, k, n):
    """``benchmarks/kernel_bench.py``'s structured B: 45% of the 256-row
    blocks live, the rest all zero."""
    import numpy as np
    b = rng.standard_normal((k, n)).astype(np.float32)
    live = rng.random(k // 256) < 0.45
    b[~np.repeat(live, 256)] = 0.0
    return b


def primitives_ss_gemm(torch) -> dict:
    """ss-gemm at the paper's size through the public ops: Problem()
    (M 16,384 x K 4,096, bfloat16 A of 128 MiB) for N 2-16, make_skinny
    and clustered B; dense, masked, compact at the live count and half of
    it, each against the float64 oracle.  Returns this run's launches."""
    import numpy as np
    from repro_torch.core.primitives import ss_gemm
    from repro_torch.kernels import ss_gemm as sg
    prob = ss_gemm.Problem()
    m, k = prob.m, prob.k
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    a64 = a.double()
    a64_abs = a64.abs()
    rng = np.random.default_rng(SEED)
    sg.reset_launch_counts()
    for n in (2, 4, 8, 16):
        for label, b_np in (
                ("make_skinny", ss_gemm.make_skinny(
                    ss_gemm.Problem(n=n), SEED)),
                ("clustered", clustered_skinny(rng, k, n))):
            density, row_zero = ss_gemm.measured_sparsity(b_np)
            b = torch.from_numpy(b_np).cuda().to(torch.bfloat16)
            b64 = b.double()
            want = ss_gemm.reference(a64, b64, dtype=torch.float64)
            bnd = ss_gemm.reference(a64_abs, b64.abs(), dtype=torch.float64)
            occ = sg.block_occupancy(b, 256)
            nk, live = occ.shape[0], int(occ.sum())
            runs = {"dense": sg.ssgemm(a, b, sparsity_aware=False),
                    "masked": sg.ssgemm_masked(a, b)}
            for budget in sorted({max(live, 1), max(live // 2, 1)}):
                runs[f"compact@{budget}"] = sg.ssgemm_compact(a, b,
                                                              budget=budget)
            parts = []
            for name, got in runs.items():
                ok, err, ratio = summed_within(got, want, bnd, k)
                check(ok and got.shape == (m, n),
                      f"ss-gemm {name} N={n} {label}: outside the float32 "
                      f"bound (err {err:.3e}, {ratio:.2f} of it)")
                parts.append(f"{name} {err:.2e} ({ratio:.3f})")
            torch.cuda.synchronize()
            print(f"[primitives] ss-gemm M={m} K={k} N={n} bf16 {label}: "
                  f"density {density:.3f}, zero rows {row_zero:.1%}, blocks "
                  f"skipped {nk - live}/{nk} ({(nk - live) / nk:.1%}); "
                  f"max_abs_err (share of bound): {', '.join(parts)}")
    print(f"[primitives] ss-gemm launches {sg.launch_counts}, routes "
          f"{sg.route_counts}")
    check(sg.launch_counts["ssgemm_masked"] == 16,
          "ss-gemm: dense + masked runs != 2 x 8 masked-kernel launches")
    check(sg.route_counts["tensor_core"] == sum(sg.launch_counts.values())
          and sg.route_counts["cuda_core"] == 0,
          "ss-gemm: a bf16 Problem() launch missed the tensor-core route")
    return dict(sg.launch_counts)


def primitives_push(torch) -> dict:
    """One push iteration, push_scatter(values, 0.85 values[src], dst), on
    each of the three paper graphs in full, against the float64 oracle.
    Returns this run's launches."""
    from repro_torch.core.primitives import graphs, push
    from repro_torch.kernels import push_scatter as ps
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ps.reset_launch_counts()
    for g in graphs.paper_inputs(SEED):
        t0 = time.perf_counter()
        src, dst = g.edges(g.n_edges, SEED)
        t_gen = time.perf_counter() - t0
        s, d = torch.from_numpy(src).cuda(), torch.from_numpy(dst).cuda()
        del src, dst
        values = torch.randn(g.n_nodes, generator=gen, device="cuda")
        got = ps.push_scatter(values, 0.85 * values[s], d)
        want = push.reference(values.double(), s, d, g.n_nodes)
        bnd = push.reference(values.double().abs(), s, d, g.n_nodes)
        # n per node: its value, its updates, and one more rounding per
        # update for the constant 0.85, which is rounded to float32 in the
        # port's contributions and kept in float64 by the oracle
        terms = 2 + torch.bincount(d, minlength=g.n_nodes).double()
        ok, err, ratio = summed_within(got, want, bnd, terms)
        share = float((ps.hot_set(d, g.n_nodes)[d] >= 0).float().mean())
        torch.cuda.synchronize()
        print(f"[primitives] push {g.name}: {g.n_nodes} nodes, {d.numel()} "
              f"updates (edges drawn in {t_gen:.1f}s); hot share "
              f"{share:.2%} (hot set 1024); max_abs_err {err:.3e} "
              f"({ratio:.3f} of the float32 bound)")
        check(ok and bool(torch.isfinite(got).all()),
              f"push {g.name}: outside the float32 bound")
        del s, d, values, got, want, bnd, terms
    print(f"[primitives] push launches {ps.launch_counts}")
    check(ps.launch_counts["push_scatter"] == 3,
          "push: launches != one per graph")
    return dict(ps.launch_counts)


def primitive_timings(torch) -> dict:
    """Times of the three kernels at the primitives phase's shapes:
    ss-gemm at Problem() (bf16) at N 4 and, as ``n16_*``, N 16, masked on
    make_skinny data (every block live) and compact on the clustered B at
    budget = the live count; push on powerlaw-1M-10M (10 M updates, hot
    1,024).  Printed only: the other walk on each B, the two routes side by
    side at N 2-16, and the float32 route at N 16 beside float32
    ``torch.matmul``."""
    import numpy as np
    from repro_torch.core.primitives import graphs, ss_gemm
    from repro_torch.kernels import push_scatter as ps
    from repro_torch.kernels import ss_gemm as sg
    prob = ss_gemm.Problem()
    m, k, bk, item = prob.m, prob.k, 256, 2
    ext = sg.kernel.load_extension()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    a64 = a.double()
    rng = np.random.default_rng(SEED + 1)
    out, extra = {}, []
    for n in (4, 16):
        for label, b_np in (("make_skinny", ss_gemm.make_skinny(
                ss_gemm.Problem(n=n), SEED)), ("clustered",
                                              clustered_skinny(rng, k, n))):
            b = torch.from_numpy(b_np).cuda().to(torch.bfloat16)
            mask = sg.block_occupancy(b, bk)
            nk, live = mask.shape[0], int(mask.sum())
            cols = min(live * bk, k)
            nbytes = (m * cols * item + k * n * item + m * n * 4)
            flops = 2.0 * m * cols * n
            idx = torch.argsort(-mask, stable=True)[:max(live, 1)].to(
                torch.int32)
            nl = torch.tensor([live], dtype=torch.int32, device="cuda")
            lib = time_ms(lambda i: torch.matmul(a, b), 20)
            c_out = torch.empty(m, n, device="cuda")
            for kname, run, bare, plain, extra_bytes in (
                    ("ssgemm_masked",
                     lambda i: sg.kernel.ssgemm_masked_cuda(a, b, mask, bk),
                     lambda i: ext.ssgemm_masked_tc(a, b, mask, bk, c_out),
                     lambda i: sg.ssgemm_masked_ref(a, b, mask, bk), nk * 4),
                    ("ssgemm_compact",
                     lambda i: sg.kernel.ssgemm_compact_cuda(a, b, idx, nl,
                                                             bk),
                     lambda i: ext.ssgemm_compact_tc(a, b, idx, nl, bk,
                                                     c_out),
                     lambda i: sg.ssgemm_compact_ref(a, b, idx, nl, bk),
                     idx.numel() * 4 + 4)):
                got = run(0)
                b64 = b.double()
                want = (sg.ssgemm_masked_ref(a64, b64, mask, bk)
                        if kname == "ssgemm_masked" else
                        sg.ssgemm_compact_ref(a64, b64, idx, nl, bk))
                err = float((got.double() - want).abs().max())
                t_bound, by = bound(nbytes + extra_bytes, flops, "bfloat16")
                row = {"ms": time_ms(run, 50),
                       "plain_ms": time_ms(plain, 5, reps=3),
                       "library_ms": lib, "bound_ms": t_bound,
                       "bound_by": by, "max_abs_err": err,
                       "shape": f"M={m} K={k} N={n} bk={bk} bf16 {label}, "
                                f"{live}/{nk} blocks live"}
                line = (f"[timing] {kname} ({row['shape']}): kernel_ms "
                        f"{row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, "
                        f"library_ms (torch.matmul, dense) {lib:.4f}, "
                        f"bound_ms {t_bound:.4f} ({by}), max_abs_err vs "
                        f"float64 {err:.3e}; through the binding entry, "
                        f"without the Python wrapper, "
                        f"{time_ms(bare, 50):.4f} ms")
                main = (kname, label) in (("ssgemm_masked", "make_skinny"),
                                          ("ssgemm_compact", "clustered"))
                if main and n == 4:
                    out[kname] = row
                elif main:
                    out[kname].update({
                        "n16_ms": row["ms"], "n16_plain_ms": row["plain_ms"],
                        "n16_library_ms": lib, "n16_bound_ms": t_bound,
                        "n16_flops": flops})
                (print if main else extra.append)(line)
    for line in extra:
        print(line)
    out["ssgemm_masked_by_n"] = ssgemm_route_timings(torch, a, bk)

    g = {x.name: x for x in graphs.paper_inputs(SEED)}["powerlaw-1M-10M"]
    src, dst = g.edges(g.n_edges, SEED)
    s, d = torch.from_numpy(src).cuda(), torch.from_numpy(dst).cuda()
    values = torch.randn(g.n_nodes, generator=gen, device="cuda")
    contrib = 0.85 * values[s]
    hot = 1024
    slots = ps.hot_set(d, g.n_nodes, hot)[d]
    u = d.numel()
    hot_acc, cold = ps.kernel.push_scatter_cuda(slots, contrib, hot)
    want, want_cold = ps.push_scatter_kernel_ref(slots, contrib.double(), hot)
    err = max(float((hot_acc.double() - want).abs().max()),
              float((cold.double() - want_cold).abs().max()))
    t_bound, by = bound(12.0 * u + 4 * hot, float(u), "float32")
    out["push_scatter"] = {
        "ms": time_ms(lambda i: ps.kernel.push_scatter_cuda(
            slots, contrib, hot), 50),
        "plain_ms": time_ms(lambda i: ps.push_scatter_kernel_ref(
            slots, contrib, hot), 10, reps=3),
        "library_ms": time_ms(lambda i: values.index_add(
            0, d, contrib), 50),
        "bound_ms": t_bound, "bound_by": by, "max_abs_err": err,
        "shape": f"{g.name}: U={u} updates, hot={hot}"}
    op_ms = time_ms(lambda i: ps.push_scatter(values, contrib, d), 10,
                    reps=3)
    row = out["push_scatter"]
    print(f"[timing] push_scatter ({row['shape']}): kernel_ms "
          f"{row['ms']:.4f}, plain_ms {row['plain_ms']:.4f}, library_ms "
          f"(op-level: values.index_add of the whole op) "
          f"{row['library_ms']:.4f}, bound_ms {t_bound:.4f} ({by}), "
          f"max_abs_err vs float64 {err:.3e}; the whole push_scatter op "
          f"{op_ms:.4f} ms")
    return out


def ssgemm_route_timings(torch, a, bk: int) -> dict[int, float]:
    """The masked walk on both routes at Problem() (bf16 A, make_skinny B)
    for N 2-16: the tensor-core walk, which ``route`` picks there, and the
    CUDA-core walk called through its own binding entry; then the float32
    route at N 16 beside float32 ``torch.matmul``.  Printed, and the
    tensor-core walk's ms returned by N (the ``[pim]`` phase reads them)."""
    from repro_torch.core.primitives import ss_gemm
    from repro_torch.kernels import ss_gemm as sg
    ext = sg.kernel.load_extension()
    parts, by_n = [], {}
    for n in (2, 4, 8, 16):
        b = torch.from_numpy(ss_gemm.make_skinny(ss_gemm.Problem(n=n),
                                                 SEED)).cuda().bfloat16()
        mask = sg.block_occupancy(b, bk)
        check(sg.route(a, b, bk) == "tensor_core",
              "ss-gemm: Problem() bf16 does not take the tensor-core route")
        out = torch.empty(a.shape[0], n, device="cuda")
        tc = time_ms(lambda i: sg.kernel.ssgemm_masked_cuda(
            a, b, mask, bk), 50)
        cc = time_ms(lambda i: ext.ssgemm_masked(a, b, mask, bk, out),
                     50)
        lib = time_ms(lambda i: torch.matmul(a, b), 50)
        by_n[n] = tc
        parts.append(f"N {n}: tensor-core {tc:.4f}, CUDA-core {cc:.4f}, "
                     f"torch.matmul {lib:.4f}")
    print("[timing] ssgemm_masked routes, M=16384 K=4096 bf16 make_skinny "
          "(ms): " + "; ".join(parts))
    a32, b32 = a.float(), b.float()
    check(sg.route(a32, b32, bk) == "cuda_core",
          "ss-gemm: float32 does not take the CUDA-core route")
    f32 = time_ms(lambda i: sg.kernel.ssgemm_masked_cuda(
        a32, b32, mask, bk), 20)
    lib = time_ms(lambda i: torch.matmul(a32, b32), 20)
    t_bound, by = bound(a32.numel() * 4 + b32.numel() * 4 + a.shape[0] * 64,
                        2.0 * a32.numel() * 16, "float32")
    print(f"[timing] ssgemm_masked float32 route (CUDA-core walk), M=16384 "
          f"K=4096 N=16 make_skinny: kernel_ms {f32:.4f}, torch.matmul "
          f"(float32, TF32 off) {lib:.4f}, bound_ms {t_bound:.4f} ({by})")
    del a32, b32
    return by_n


# ---------------------------------------------------------------------------
# the wave step's kernels (volume, flux1d) and vector-sum
# ---------------------------------------------------------------------------

MANTISSA = {"float32": 24, "bfloat16": 8}


def ulp(torch, x, dtype_name):
    """The spacing of the dtype's values at |x| (both dtypes have float32's
    exponent range)."""
    m = x.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m))
                      - (MANTISSA[dtype_name] - 1))


def volume_within(torch, got, x64, w64, n_terms=27
                  ) -> tuple[bool, float, float]:
    """Per output, |got - want| <= gamma(n_terms) x sum |x_i w_ij|
    (float64 from the same x and the same rounded W), plus, for a bfloat16
    output, its own last rounding, 2**-8 |got|.  ``n_terms`` is 27 for
    any summation of a row, 7 for the stencil's chains.  Returns (ok, max
    abs error, largest error as a share of its bound)."""
    from repro_torch.kernels.wavesim_volume import volume_kernel_ref
    want = volume_kernel_ref(x64, w64)
    lim = gamma(n_terms) * volume_kernel_ref(x64.abs(), w64.abs())
    if got.dtype != torch.float32:
        lim = lim + 2.0 ** -8 * got.double().abs()
    err = (got.double() - want).abs()
    ratio = float((err / lim.clamp_min(1e-300)).max())
    return bool((err <= lim).all()), float(err.max()), ratio


def walk_rows(torch) -> list[int]:
    """Row counts that end a persistent CTA's walk of the volume kernel
    at each point of its ring: 1, a tile less or more one row, a tile for
    every CTA of the grid less or more one row, and a walk that wraps the
    ring."""
    from repro_torch.kernels.wavesim_volume import kernel as vk
    sms = sm_count(torch.device("cuda", 0))
    grid = vk.CTAS_PER_SM * sms * vk.TILE_ROWS
    return [1, 255, 257, grid - 1, grid, grid + 1,
            4 * grid + 3 * vk.TILE_ROWS + 5]


def span_lengths(dtype) -> list[int]:
    """Lengths of ``dtype`` elements at which the vector-sum kernel's
    spans change shape, each less one, as is and plus one: one row of
    16-byte chunks, one span of ``UNROLL`` rows, a span and a row, five
    spans, and five spans and a row."""
    from repro_torch.kernels.vector_sum import kernel as vk
    row, unroll = vk.THREADS * (16 // dtype.itemsize), vk.UNROLL
    return [m * row + d for m in (1, unroll, unroll + 1, 5 * unroll,
                                  5 * unroll + 1)
            for d in (-1, 0, 1)]


def wave_kernel_checks(torch) -> None:
    """The three kernels against their plain versions on the card: volume
    within the float32 bounds of 27-term and of 7-term sums (ragged last
    tiles, c 1.0 and 0.7, the row counts of :func:`walk_rows` on aligned
    and unaligned bases) and refusing a W off the stencil's pattern;
    flux1d equal at alpha 0.5 and within one ulp at 0.3 (the plain version
    rounds twice in bfloat16); vector-sum exactly a + b, also at the
    lengths of :func:`span_lengths`."""
    from repro_torch.kernels import vector_sum as vs
    from repro_torch.kernels import wavesim_flux as wf
    from repro_torch.kernels import wavesim_volume as wv
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst, n_checks = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for e, f in ((1, 1), (8, 9), (65, 27), (256, 3), (64000, 27)):
            x = torch.randn(e * f, 27, generator=gen, device="cuda").to(dtype)
            x64 = x.double()
            for c in (1.0, 0.7):
                w, sten = wv.ops.operator(c, dtype)
                got = wv.kernel.volume_cuda(x, sten)
                for n_terms in (27, 7):
                    ok, err, ratio = volume_within(torch, got, x64,
                                                   w.double(), n_terms)
                    n_checks += 1
                    key = f"{name} gamma({n_terms})"
                    worst[key] = max(worst.get(key, 0.0), ratio)
                    check(ok and got.dtype == dtype,
                          f"wavesim_volume outside the gamma({n_terms}) "
                          f"bound ({dtype}, E={e} F={f} c={c}): err "
                          f"{err:.3e}, {ratio:.2f} of it")
        # the persistent walk: rows that end it anywhere in the ring, on an
        # aligned base (bulk copies, the ragged tile on the plain path) and
        # one element past it (every tile on the plain path)
        for rows in walk_rows(torch):
            buf = torch.randn(rows * 27 + 1, generator=gen,
                              device="cuda").to(dtype)
            for off in (0, 1):
                x = buf[off:off + rows * 27].view(rows, 27)
                w, sten = wv.ops.operator(0.7, dtype)
                got = wv.kernel.volume_cuda(x, sten)
                for n_terms in (27, 7):
                    ok, err, ratio = volume_within(torch, got, x.double(),
                                                   w.double(), n_terms)
                    n_checks += 1
                    key = f"{name} gamma({n_terms})"
                    worst[key] = max(worst.get(key, 0.0), ratio)
                    check(ok, f"wavesim_volume outside the gamma({n_terms})"
                          f" bound ({dtype}, {rows} rows, base offset "
                          f"{off})")
        # a W off the stencil's pattern has no stencil, and the wrapper
        # takes nothing but a stencil: refused before any launch
        before = wv.launch_counts["wavesim_volume"]
        for bad in (0.5, float("nan")):
            w = wv.fused_operator(1.0, dtype).clone()
            w[0, 26] = bad                  # nodes (0,0,0) and (2,2,2)
            for refuse in (lambda: wv.stencil_operator(w),
                           lambda: wv.kernel.volume_cuda(x, w)):
                try:
                    refuse()
                except ValueError:
                    continue
                raise SmokeFailure(f"wavesim_volume took an off-pattern W "
                                   f"({dtype}, W[0, 26] = {bad})")
        check(wv.launch_counts["wavesim_volume"] == before,
              "wavesim_volume launched on an off-pattern W")
    print(f"[kernels] wavesim_volume float32/bfloat16, (E, F) (1, 1) to "
          f"(64000, 27), c 1.0/0.7, and rows {walk_rows(torch)} on an "
          f"aligned and an unaligned base: {n_checks} checks within the "
          f"float32 bounds of 27-term and of the stencil's 7-term sums "
          f"(largest error as a share of its bound: "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
          + "; the bfloat16 bound adds the output's own rounding, which a "
          "tie reaches); an off-pattern W (0.5, NaN) refused")

    n_checks, worst_ulps = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for e, t in ((1, 9), (4, 9), (600, 27), (1024, 128), (64000, 243)):
            hi = torch.randn(e, t, generator=gen, device="cuda").to(dtype)
            lo = torch.randn(e, t, generator=gen, device="cuda").to(dtype)
            for alpha in (0.5, 0.3):
                got = wf.kernel.flux1d_cuda(hi, lo, alpha)
                want = wf.flux1d_ref(hi, lo, alpha)
                for g, w_ in zip(got, want):
                    n_checks += 1
                    if alpha == 0.5:
                        check(torch.equal(g, w_), f"flux1d differs from its "
                              f"plain version ({name}, E={e} T={t})")
                        continue
                    ulps = float(((g.double() - w_.double()).abs() / ulp(
                        torch, torch.maximum(g.double().abs(),
                                             w_.double().abs()),
                        name)).max())
                    worst_ulps = max(worst_ulps, ulps)
                    check(ulps <= 1.0, f"flux1d more than one ulp from its "
                          f"plain version ({name}, E={e} T={t} alpha 0.3)")
    print(f"[kernels] flux1d float32/bfloat16, (E, T) (1, 9) to (64000, "
          f"243): {n_checks} outputs, equal to the plain version at alpha "
          f"0.5; at 0.3 at most {worst_ulps:.0f} ulp apart")

    n_checks = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for shape in ((0,), (1,), (7,), (512,), (10_000,), (64 << 20,),
                      (3, 5, 7), *((n,) for n in span_lengths(dtype))):
            a = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            b = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            got = vs.kernel.vector_sum_cuda(a, b)
            n_checks += 1
            check(torch.equal(got, vs.vector_sum_ref(a, b)),
                  f"vector_sum is not a + b ({dtype}, shape {shape})")
        buf = torch.randn(2, 10_001, generator=gen, device="cuda").to(dtype)
        a, b = buf[0, 1:], buf[1, 1:]      # one element past 16 bytes
        n_checks += 1
        check(torch.equal(vs.kernel.vector_sum_cuda(a, b), a + b),
              f"vector_sum is not a + b on an unaligned view ({dtype})")
    torch.cuda.synchronize()
    print(f"[kernels] vector_sum float32/bfloat16/float16, n 0 to 64 Mi, "
          f"(3, 5, 7), the span boundaries +-1 (float32 "
          f"{span_lengths(torch.float32)}), an unaligned view: {n_checks} "
          f"checks, each exactly a + b")


def wave_timings(torch) -> dict:
    """Times at the paper's sizes: volume at ``wavesim.Problem()`` (R =
    1,728,000 rows of 27) and flux1d at E 64,000 x T 243
    (``Problem().face_points``), both in float32 (the wave path's dtype;
    bfloat16 printed beside, and in volume's row as ``bf16_*``),
    vector-sum at n = 64 Mi in float16 (the paper's elements).  Volume and
    vector-sum also on the device alone (``graph_ms``, the library call's
    ``library_graph_ms``: the same calls captured in one CUDA graph).  The
    kernels' products and sums run on the CUDA cores in float32 whatever
    the dtype, so their operations are reckoned at the float32 rate; the
    volume kernel's are the stencil's 189 multiply-adds a row."""
    from repro_torch.core.primitives import vector_sum as vs_core
    from repro_torch.core.primitives import wavesim
    from repro_torch.kernels import vector_sum as vs
    from repro_torch.kernels import wavesim_flux as wf
    from repro_torch.kernels import wavesim_volume as wv
    prob = wavesim.Problem()
    rows = prob.n_elements * prob.n_fields
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    out, extra = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        item = dtype.itemsize
        u = torch.randn(prob.n_elements, prob.n_fields, 3, 3, 3,
                        generator=gen, device="cuda").to(dtype)
        x = u.view(rows, 27)
        w, sten = wv.ops.operator(1.0, dtype)     # what the op passes
        w_dev = w.cuda()
        got = wv.kernel.volume_cuda(x, sten)
        _, err, _ = volume_within(torch, got, x.double(), w.double())
        nbytes = 2.0 * rows * 27 * item + sten.numel() * 4
        t_bound, by = bound(nbytes, 2.0 * rows * sten.numel(), "float32")
        row = {"ms": time_ms(lambda i: wv.kernel.volume_cuda(
                   x, sten), 20),
               "graph_ms": graph_ms(lambda i: wv.kernel.volume_cuda(
                   x, sten), 20),
               "plain_ms": time_ms(lambda i: wv.volume_kernel_ref(
                   x, w_dev), 10),
               "library_ms": time_ms(lambda i: torch.matmul(
                   x, w_dev), 20),
               "library_graph_ms": graph_ms(lambda i: torch.matmul(
                   x, w_dev), 20),
               "bound_ms": t_bound, "bound_by": by, "max_abs_err": err,
               "bytes": nbytes,
               "shape": f"Problem(): R={rows} rows of 27, {name}"}
        einsum_ms = time_ms(lambda i: wv.volume_ref(u), 3, reps=3)
        line = (f"[timing] wavesim_volume ({row['shape']}): kernel_ms "
                f"{row['ms']:.4f}, device only {row['graph_ms']:.4f}; "
                f"plain_ms {row['plain_ms']:.4f}, library_ms "
                f"(torch.matmul) {row['library_ms']:.4f}, device only "
                f"{row['library_graph_ms']:.4f}; bound_ms {t_bound:.4f} "
                f"({by}), max_abs_err vs float64 {err:.3e}; the core "
                f"einsums {einsum_ms:.4f} ms")
        if dtype == torch.float32:
            out["wavesim_volume"] = row
            print(line)
        else:
            out["wavesim_volume"].update(
                {f"bf16_{k}": v for k, v in row.items() if k != "shape"})
            extra.append(line)
        del u, x, got

        e, t = prob.n_elements, prob.face_points
        hi = torch.randn(e, t, generator=gen, device="cuda").to(dtype)
        lo = torch.randn(e, t, generator=gen, device="cuda").to(dtype)
        got = wf.kernel.flux1d_cuda(hi, lo, 0.5)
        want = wf.flux1d_ref(hi, lo, 0.5)
        err = max(float((g.double() - w_.double()).abs().max())
                  for g, w_ in zip(got, want))
        t_bound, by = bound(4.0 * e * t * item, 4.0 * e * t, "float32")
        row = {"ms": time_ms(lambda i: wf.kernel.flux1d_cuda(
                   hi, lo, 0.5), 20),
               "plain_ms": time_ms(lambda i: wf.flux1d_ref(
                   hi, lo, 0.5), 10),
               "library_ms": None, "bound_ms": t_bound, "bound_by": by,
               "max_abs_err": err, "shape": f"E={e} T={t}, {name}"}
        line = (f"[timing] flux1d ({row['shape']}): kernel_ms "
                f"{row['ms']:.4f}, plain_ms (torch.roll) "
                f"{row['plain_ms']:.4f}, library_ms null (no single call), "
                f"bound_ms {t_bound:.4f} ({by}), max_abs_err vs plain "
                f"{err:.3e}")
        if dtype == torch.float32:
            out["flux1d"] = row
            print(line)
        else:
            extra.append(line)
        del hi, lo, got, want

    n = 64 << 20
    a = torch.randn(n, generator=gen, device="cuda").to(torch.float16)
    b = torch.randn(n, generator=gen, device="cuda").to(torch.float16)
    got = vs.kernel.vector_sum_cuda(a, b)
    err = float((got.double() - vs_core.reference(a, b).double()).abs().max())
    t_bound, by = bound(3.0 * n * 2, float(n), "float32")
    row = {"ms": time_ms(lambda i: vs.kernel.vector_sum_cuda(a, b),
                         20),
           "graph_ms": graph_ms(lambda i: vs.kernel.vector_sum_cuda(
               a, b), 20),
           "plain_ms": time_ms(lambda i: vs.vector_sum_ref(a, b), 20),
           "library_ms": time_ms(lambda i: torch.add(a, b), 20),
           "library_graph_ms": graph_ms(lambda i: torch.add(a, b),
                                        20),
           "bound_ms": t_bound, "bound_by": by, "max_abs_err": err,
           "bytes": 3.0 * n * 2, "shape": f"n={n} float16"}
    out["vector_sum"] = row
    print(f"[timing] vector_sum ({row['shape']}): kernel_ms "
          f"{row['ms']:.4f}, device only {row['graph_ms']:.4f}; plain_ms "
          f"(a + b) {row['plain_ms']:.4f}, library_ms (torch.add) "
          f"{row['library_ms']:.4f}, device only "
          f"{row['library_graph_ms']:.4f}; bound_ms {t_bound:.4f} ({by}), "
          f"max_abs_err vs a + b {err:.3e}")
    for line in extra:
        print(line)
    return out


def flux_magnitudes(torch, a, alpha):
    """Per node, the sum of |terms| of ``wavesim.flux`` on values whose
    magnitudes are ``a``: alpha (|neighbour| + |own|) for each face."""
    rhs = torch.zeros_like(a)
    for axis in range(3):
        na = axis + 4
        rhs.select(na, 2).add_(alpha * (torch.roll(a, -1, axis).select(na, 0)
                                        + a.select(na, 2)))
        rhs.select(na, 0).add_(alpha * (torch.roll(a, 1, axis).select(na, 2)
                                        + a.select(na, 0)))
    return rhs


def lines_agree(got: list[str], want: list[str]) -> bool:
    """The same energy lines to their printed precision: the same steps,
    each number within one unit of its last printed place (float32 sums
    taken in another order may round the last digit the other way)."""
    import re
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        gn, wn = re.findall(r"-?[\d.]+", g), re.findall(r"-?[\d.]+", w)
        if len(gn) != len(wn) or gn[0] != wn[0]:
            return False
        for a, b in zip(gn[1:], wn[1:]):
            places = len(a.split(".")[1]) if "." in a else 0
            if abs(float(a) - float(b)) > 1.01 * 10.0 ** -places:
                return False
    return True


def wave_path(torch) -> tuple[dict, float]:
    """Phase 7: the wave demo through ``wave_demo.run`` at the demo's size
    (card against the CPU's plain path) and at ``Problem()`` (one step
    against float64, then 5 timed steps), then flux1d and vector-sum
    through their public ops at the paper's sizes.  Returns this phase's
    launches and the median ms of a step's plain flux and update at
    ``Problem()``."""
    from repro_torch.core.primitives import vector_sum as vs_core
    from repro_torch.core.primitives import wavesim
    from repro_torch.kernels import vector_sum as vs
    from repro_torch.kernels import wavesim_flux as wf
    from repro_torch.kernels import wavesim_volume as wv
    from repro_torch.launch import wave_demo
    for mod in (wv, wf, vs):
        mod.reset_launch_counts()

    on_card = wave_demo.run(device="cuda", verbose=False)
    on_cpu = wave_demo.run(device="cpu", verbose=False)
    err = float((on_card["u"].cpu() - on_cpu["u"]).abs().max())
    for line in on_card["energy"]:
        print(f"[wave] demo on the card: {line}")
    print(f"[wave] demo 8^3 x 3 fields, 40 steps, float32: card vs CPU "
          f"plain path max |du| {err:.3e} (limit 1e-5); energy lines agree "
          f"{lines_agree(on_card['energy'], on_cpu['energy'])}")
    check(err <= 1e-5, "wave demo: the card's u differs from the CPU's")
    check(lines_agree(on_card["energy"], on_cpu["energy"]),
          "wave demo: the energy lines differ")
    check(wv.launch_counts["wavesim_volume"] == 40,
          "wave demo: volume launches != one per step")

    prob = wavesim.Problem()
    grid, fields, dt = prob.grid, prob.n_fields, wave_demo.DEMO_DT
    u0 = wave_demo.initial_state(grid, fields, device="cuda", seed=SEED)
    one = wave_demo.run(grid, fields, 1, dt, device="cuda", seed=SEED,
                        verbose=False)["u"]
    u64 = u0.double()
    want = wavesim.step(u64, dt=dt)
    w64 = wv.fused_operator(1.0, torch.float32).double()
    vmag = wv.volume_kernel_ref(u64.abs().reshape(-1, 27), w64.abs())
    mag = u64.abs() + dt * (vmag.reshape(u64.shape)
                            + flux_magnitudes(torch, u64.abs(), 0.5))
    # 27 roundings in a volume sum, 4 in a flux sum, then rhs_v + rhs_f,
    # dt (rounded to float32) times it, and u plus that: at most 32
    lim = gamma(32) * mag
    errs = (one.double() - want).abs()
    ratio = float((errs / lim.clamp_min(1e-300)).max())
    print(f"[wave] Problem() {grid} x {fields} fields, one step, float32 vs "
          f"float64: max_abs_err {float(errs.max()):.3e} ({ratio:.3f} of the "
          f"float32 bound, gamma_32 x sum |terms|)")
    check(bool((errs <= lim).all()) and one.shape == u0.shape,
          "wave Problem(): one step outside the float32 bound")
    del u0, one, u64, want, vmag, mag, lim, errs

    steps = 5
    res = wave_demo.run(grid, fields, steps, dt, device="cuda", seed=SEED,
                        verbose=False)
    u = res["u"]
    check(u.shape == tuple(grid) + (fields, 3, 3, 3)
          and bool(torch.isfinite(u).all()),
          "wave Problem(): u not finite or of the wrong shape")
    step_ms, vol_ms = res["step_ms"], res["volume_ms"]
    flux_ms = statistics.median(step_ms) - statistics.median(vol_ms)
    print(f"[wave] Problem() {grid} x {fields} fields ({u.numel()} values, "
          f"{u.numel() * 4 / 1e6:.1f} MB), {steps} steps, float32: "
          f"ms/step {statistics.median(step_ms):.4f} median, "
          f"{res['ms_per_step']:.4f} mean (per step "
          f"{', '.join(f'{t:.3f}' for t in step_ms)}); volume kernel "
          f"{statistics.median(vol_ms):.4f} ms median, "
          f"{sum(vol_ms) / sum(step_ms):.1%} of the step; flux and update "
          f"{flux_ms:.4f} ms")
    del u, res

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    e, t = prob.n_elements, prob.face_points
    hi = torch.randn(e, t, generator=gen, device="cuda")
    lo = torch.randn(e, t, generator=gen, device="cuda")
    fhi, flo = wf.flux1d(hi, lo, 0.5)
    want = wf.flux1d_ref(hi, lo, 0.5)
    check(torch.equal(fhi, want[0]) and torch.equal(flo, want[1]),
          "flux1d op at E 64000 x T 243 differs from its plain version")
    del hi, lo, fhi, flo, want
    n = 64 << 20
    a = torch.randn(n, generator=gen, device="cuda").to(torch.float16)
    b = torch.randn(n, generator=gen, device="cuda").to(torch.float16)
    check(torch.equal(vs.vector_sum(a, b), vs_core.reference(a, b)),
          "vector_sum op at 64 Mi float16 elements is not a + b")
    torch.cuda.synchronize()
    print(f"[wave] flux1d op E={e} T={t} float32: equal to the plain "
          f"version; vector_sum op n={n} float16: exactly a + b")
    counts = {**wv.launch_counts, **wf.launch_counts, **vs.launch_counts}
    print(f"[wave] launches {counts}")
    check(counts["wavesim_volume"] == 40 + 1 + steps,
          "wave: volume launches != one per step of the three runs")
    check(counts["flux1d"] == 1 and counts["vector_sum"] == 1,
          "wave: flux1d or vector_sum launches != one op call each")
    return counts, flux_ms


# ---------------------------------------------------------------------------
# phases 4 and 5: the serving paths
# ---------------------------------------------------------------------------

def reset_counts() -> None:
    from repro_torch.kernels import decode_attn, moe_group_gemm, paged_attn
    paged_attn.reset_launch_counts()
    decode_attn.reset_launch_counts()
    moe_group_gemm.reset_launch_counts()


def read_counts() -> dict:
    from repro_torch.kernels import decode_attn, moe_group_gemm, paged_attn
    return {**paged_attn.launch_counts, **decode_attn.launch_counts,
            **moe_group_gemm.launch_counts}


def attn_layers(cfg) -> int:
    """The attention layers a forward call runs (a shared block's every
    occurrence counts; SSM blocks do not)."""
    from repro_torch.models.init import ATTN_KINDS
    return sum(seg.count for seg in cfg.resolved_segments()
               if seg.kind in ATTN_KINDS)


def check_serve_launches(res: dict, counts: dict, cfg, label: str,
                         paged: bool, spec: bool = False) -> None:
    """The decode kernels' launches of one serve run, exact: a decode
    graph's launches count at each replay, so the counts equal those of
    the eager loop over the same segments.  With speculation (``spec``)
    every decode step is a verify, a prefill-kernel call at Lq = k+1, so
    the prefill kernel runs once a layer for each join and each step, and
    the decode kernel never.  Where the degradation controller shed
    speculation for part of a run, ``res["spec_segments"]`` of its
    segments ran the verify loop and the rest the plain one: the prefill
    kernel runs once a layer for each join and each verify step, the
    decode kernel once a layer for each plain step.  "A layer" is an
    attention layer: zamba2's shared block counts once an occurrence, an
    SSM block not at all.  An MLA model attends through ``gather_pages``
    and the dense core, as JAX's does, and mamba2 does not attend: no
    attention kernel runs for either, so every one of their counts must be
    0."""
    layers = attn_layers(cfg)
    if cfg.attn.value == "mla" or not layers:
        check(counts["paged_decode"] == counts["paged_prefill"]
              == counts["decode_attn"] == 0,
              f"serve {label}: an attention kernel ran for a model with no "
              "kernel attention (MLA or attention-free)")
        return
    per_segment = layers * res["sync_every"]
    steps = per_segment * res["segments"]
    verify = per_segment * res.get("spec_segments",
                                   res["segments"] if spec else 0)
    if spec:
        check(verify == steps, f"serve {label}: a segment ran the plain "
              "loop while speculating")
    if verify:
        check(counts["paged_prefill"]
              == layers * res["joins"] + verify,
              f"serve {label}: prefill launches != layers x (joins + "
              "verify steps)")
        check(counts["paged_decode"] == steps - verify
              and counts["decode_attn"] == 0,
              f"serve {label}: decode launches != layers x plain steps, "
              "or the dense decode kernel was launched")
    elif paged:
        check(counts["paged_prefill"] == layers * res["joins"],
              f"serve {label}: prefill launches != layers x joins")
        check(counts["paged_decode"] == steps,
              f"serve {label}: decode launches != layers x steps")
        check(counts["decode_attn"] == 0,
              f"serve {label}: the dense decode kernel was launched")
    else:
        check(counts["decode_attn"] == steps,
              f"serve {label}: decode_attn launches != layers x steps")
        check(counts["paged_decode"] == counts["paged_prefill"] == 0,
              f"serve {label}: a paged kernel was launched")


def serve_both(torch, arch, params, label: str, warm_gate: bool = True,
               **kw) -> dict:
    """One serve cell through ``repro_torch.launch.serve.run``, with CUDA
    graphs (the default: the main path, whose launches are counted) and
    eagerly (kernel by kernel), each a first and a warm wave.  The warm
    wave gives the first wave's tokens (gated unless ``warm_gate`` is
    off: then the equal streams are counted), and graphs give the eager
    run's greedy streams.  Returns {"graphs": (result, launches), "eager":
    ...}; each run's launches and peak device memory (``peak_gib``, the
    weights included) are its own run's."""
    from repro_torch.launch.serve import run
    out = {}
    for mode, graphs in (("graphs", None), ("eager", False)):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = run(arch, params=params, graphs=graphs, device="cuda", **kw)
        counts = read_counts()
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["sync_every"] = kw["sync_every"]
        out[mode] = (res, counts)
        print(f"[serve] {label}, {mode}: tok/s first wave "
              f"{res['tok_per_s']:.1f} (capture included), warm wave "
              f"{res['warm_tok_per_s']:.1f}; {res['graph_count']} graphs, "
              f"{res['capture_s']:.3f}s capturing; {res['joins']} joins, "
              f"{res['segments']} segments over both waves; TTFT p50 "
              f"{res['latency']['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
              f"{res['latency']['tpot_p50_s'] * 1e3:.2f} ms (warm); peak "
              f"device memory {res['peak_gib']:.2f} GiB; launches {counts}; "
              f"{SMI}")
        check(res["graphs"] == (mode == "graphs")
              and (res["graph_count"] > 0) == (mode == "graphs"),
              f"serve {label} {mode}: graphs {res['graph_count']}")
        if warm_gate:
            check(res["warm_results"] == res["results"],
                  f"serve {label} {mode}: the warm wave's tokens differ "
                  "from the first wave's")
    diff = [rid for rid, toks in out["graphs"][0]["results"].items()
            if toks != out["eager"][0]["results"][rid]]
    print(f"[serve] {label}: greedy streams, graphs vs eager: "
          f"{len(out['graphs'][0]['results']) - len(diff)}/"
          f"{len(out['graphs'][0]['results'])} equal")
    check(not diff, f"serve {label}: graphs and eager streams differ for "
          f"requests {diff}")
    return out


def serve_full_width(torch, params, paged: bool) -> tuple[dict, dict]:
    """One layout's serve cell, graphed and eager; returns the graphed
    run's result and kernel launches (the main path's)."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    requests, max_new = 16, 64
    layout = "paged" if paged else "dense"
    runs = serve_both(torch, ARCH, params, f"{ARCH} {layout}",
                      requests=requests, max_new=max_new, batch=8,
                      max_len=1024, paged=paged, page_size=16, sync_every=8,
                      seed=0, prompt_len=(64, 513), dtype=torch.bfloat16)
    for mode, (res, counts) in runs.items():
        lens = sorted(len(p) for p in res["prompts"].values())
        check(sorted(res["results"]) == list(range(requests)),
              f"serve {layout} {mode}: missing requests")
        for rid, toks in res["results"].items():
            check(len(toks) == max_new
                  and all(0 <= t < cfg.vocab for t in toks),
                  f"serve {layout} {mode}: request {rid} returned "
                  f"{len(toks)} tokens")
        check_serve_launches(res, counts, cfg, f"{layout} {mode}", paged)
    print(f"[serve] {layout}: prompts {lens[0]}-{lens[-1]} tokens")
    return runs["graphs"]


FEATURES = {
    "a": dict(prefix_cache=True, prefill_chunk=128, prefill_round_tokens=256),
    "b": dict(prefix_cache=True, prefill_chunk=128, prefill_round_tokens=256,
              speculate_k=4, speculate_ngram=2)}


def _wave_split(res: dict) -> str:
    """Where a warm wave's seconds went: its joins (host clock, each
    stalling decode) and the rest, over its decode segments."""
    join, segs = res["join"], res["segments"] - res["first_segments"]
    join_s = join["joins"] * join["mean_join_s"]
    rest = res["warm_seconds"] - join_s
    return (f"warm wave {res['warm_seconds'] * 1e3:.1f} ms: "
            f"{join['joins']} joins {join_s * 1e3:.1f} ms, {segs} segments "
            f"and collection {rest * 1e3:.1f} ms "
            f"({rest / max(1, segs * res['sync_every']) * 1e3:.2f} ms a "
            "step)")


def _equal_streams(a: dict, b: dict) -> int:
    return sum(a[rid] == b[rid] for rid in a)


def serve_features(torch, params) -> dict:
    """The serving features on the paged path: full-width qwen2-0.5b,
    bfloat16, pages of 16; 16 requests, each a seeded 256-token system
    prefix and a private suffix of 64-256 tokens, 64 new tokens each,
    batch 8, max_len 1024, 8 steps a segment.  (a) the prefix cache,
    chunks of 128 and a round budget of 256 tokens; (b) (a) and
    speculation, k 4, n-gram 2; each graphed and eager, a first and a
    warm wave; then the same traffic graphed with the prefix cache alone
    and with every feature off.

    Gated: graphed and eager streams equal for (a) and (b) (the same
    kernels in the same order); 64 in-vocab tokens a request; prefix hits
    and skipped prefill tokens in the first wave; chunk continuations;
    exact launches (with speculation the prefill kernel once a layer for
    each join and each verify step, the decode kernel never).  Not
    gated: a warm wave against its first (with the cache on the warm
    wave prefills only suffixes, in other shapes, so bfloat16 rounding
    may move a token) and features on against off; both are printed as
    counts of equal streams, and where (b) parts from off, how close the
    two tokens were (``bf16_divergence``).  Returns the graphed first
    waves' greedy streams of (a), (b), the prefix cache alone and all
    off."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run
    cfg = get_config(ARCH)
    requests, max_new = 16, 64
    kw = dict(requests=requests, max_new=max_new, batch=8, max_len=1024,
              paged=True, page_size=16, sync_every=8, seed=0,
              shared_prefix=256, prompt_len=(64, 257), dtype=torch.bfloat16)
    streams = {}
    for name, feats in FEATURES.items():
        spec = "speculate_k" in feats
        label = f"{ARCH} features ({name})"
        runs = serve_both(torch, ARCH, params, label, warm_gate=False,
                          **kw, **feats)
        for mode, (res, counts) in runs.items():
            check(sorted(res["results"]) == list(range(requests)),
                  f"serve {label} {mode}: missing requests")
            for rid, toks in res["results"].items():
                check(len(toks) == max_new
                      and all(0 <= t < cfg.vocab for t in toks),
                      f"serve {label} {mode}: request {rid} returned "
                      f"{len(toks)} tokens")
            check_serve_launches(res, counts, cfg, f"{label} {mode}", True,
                                 spec=spec)
            pre, join, sp = res["prefix"], res["first_join"], res["spec"]
            wpre, wsp, lat = res["warm_prefix"], res["warm_spec"], \
                res["latency"]
            first_lat = res["first_latency"]
            print(f"[features] {label}, {mode}: first wave: prefix hits "
                  f"{pre['hits']}/{pre['admits']}, hit rate "
                  f"{pre['hit_rate']:.3f}, prefill tokens computed "
                  f"{pre['prefill_computed']}, skipped "
                  f"{pre['prefill_skipped']}; {join['joins']} joins, "
                  f"{join['chunk_joins']} chunk continuations, "
                  f"{join['budget_deferrals']} deferrals, max join "
                  f"{join['max_join_s'] * 1e3:.1f} ms; spec "
                  f"{sp['steps']} verify steps, acceptance "
                  f"{sp['acceptance_rate']:.3f}, "
                  f"{sp['tokens_per_step']:.3f} tokens a step; TTFT p50 "
                  f"{first_lat['ttft_p50_s'] * 1e3:.1f} / p95 "
                  f"{first_lat['ttft_p95_s'] * 1e3:.1f} ms, TPOT p50 "
                  f"{first_lat['tpot_p50_s'] * 1e3:.2f} / p95 "
                  f"{first_lat['tpot_p95_s'] * 1e3:.2f} ms. Warm wave: "
                  f"hit rate {wpre['hit_rate']:.3f}, skipped "
                  f"{wpre['prefill_skipped']}, acceptance "
                  f"{wsp['acceptance_rate']:.3f}, "
                  f"{wsp['tokens_per_step']:.3f} tokens a step; TTFT p50 "
                  f"{lat['ttft_p50_s'] * 1e3:.1f} / p95 "
                  f"{lat['ttft_p95_s'] * 1e3:.1f} ms, TPOT p50 "
                  f"{lat['tpot_p50_s'] * 1e3:.2f} / p95 "
                  f"{lat['tpot_p95_s'] * 1e3:.2f} ms; {_wave_split(res)}; "
                  f"warm streams equal "
                  f"to the first wave's "
                  f"{_equal_streams(res['warm_results'], res['results'])}"
                  f"/{requests}; {SMI}")
            check(pre["hits"] > 0 and pre["prefill_skipped"] > 0,
                  f"serve {label} {mode}: no prefix hit in the first wave")
            check(join["chunk_joins"] > 0,
                  f"serve {label} {mode}: no chunk continuation")
            check(not spec or sp["steps"] > 0,
                  f"serve {label} {mode}: no verify step")
        streams[name] = runs["graphs"][0]["results"]
    for name, feats in (("prefix cache alone", dict(prefix_cache=True)),
                        ("off", {})):
        reset_counts()
        res = run(ARCH, params=params, device="cuda", **kw, **feats)
        counts = read_counts()
        res["sync_every"] = kw["sync_every"]
        check_serve_launches(res, counts, cfg, f"features {name}", True)
        check(not feats or res["prefix"]["hits"] > 0,
              f"serve features {name}: no prefix hit")
        streams[name] = res["results"]
        first, warm = res["first_latency"], res["latency"]
        print(f"[features] {ARCH} features {name}, graphs: tok/s first "
              f"wave {res['tok_per_s']:.1f}, warm wave "
              f"{res['warm_tok_per_s']:.1f}; first wave: prefix hits "
              f"{res['prefix']['hits']}/{res['prefix']['admits']}, prefill "
              f"tokens computed {res['prefix']['prefill_computed']}, "
              f"skipped {res['prefix']['prefill_skipped']}, "
              f"{res['first_join']['joins']} joins, max join "
              f"{res['first_join']['max_join_s'] * 1e3:.1f} ms; TTFT p50 "
              f"{first['ttft_p50_s'] * 1e3:.1f} / p95 "
              f"{first['ttft_p95_s'] * 1e3:.1f} ms, TPOT p50 "
              f"{first['tpot_p50_s'] * 1e3:.2f} / p95 "
              f"{first['tpot_p95_s'] * 1e3:.2f} ms; warm wave: skipped "
              f"{res['warm_prefix']['prefill_skipped']}, TTFT p50 "
              f"{warm['ttft_p50_s'] * 1e3:.1f} / p95 "
              f"{warm['ttft_p95_s'] * 1e3:.1f} ms, TPOT p50 "
              f"{warm['tpot_p50_s'] * 1e3:.2f} / p95 "
              f"{warm['tpot_p95_s'] * 1e3:.2f} ms; {_wave_split(res)}; "
              f"launches {counts}; {SMI}")
    off = streams["off"]
    print(f"[features] bfloat16 greedy streams equal (not gated): (a) vs "
          f"off {_equal_streams(streams['a'], off)}/{requests}, (b) vs off "
          f"{_equal_streams(streams['b'], off)}/{requests}, prefix cache "
          f"alone vs off "
          f"{_equal_streams(streams['prefix cache alone'], off)}/{requests}")
    bf16_divergence(torch, params, cfg, runs["graphs"][0]["prompts"],
                    streams["b"], off, "[features] bfloat16 streams with "
                    "and without speculation")
    return streams


def bf16_divergence(torch, params, cfg, prompts, got, want,
                    what: str) -> None:
    """Where two bfloat16 greedy streams of one prompt part, how close the
    two tokens were: the gap between their logits from a float32 forward
    of the same (bfloat16-valued) weights over the prompt and the common
    prefix, beside the spread of those logits (their standard deviation)
    and the margin of the top token over the third.  Printed after
    ``what``, not gated."""
    from repro_torch.models.transformer import forward, logits_fn
    params32 = _cast(torch, params, torch.float32)
    rows = []
    for rid, toks in got.items():
        diff = [j for j, (a, b) in enumerate(zip(toks, want[rid])) if a != b]
        if not diff:
            continue
        i = diff[0]
        seq = torch.tensor([prompts[rid] + want[rid][:i]],
                           device=params["embed"]["table"].device)
        with torch.no_grad():
            hidden, _ = forward(params32, {"tokens": seq}, cfg,
                                dtype=torch.float32)
            logits = logits_fn(params32, hidden[:, -1:], cfg)[0, 0]
        top = torch.topk(logits, 3).values
        rows.append((i, abs(float(logits[toks[i]] - logits[want[rid][i]])),
                     float(logits.std()), float(top[0] - top[2])))
    del params32
    torch.cuda.empty_cache()
    if rows:
        print(f"{what} part at tokens {[r[0] for r in rows]}; float32 logit gaps "
              f"there {[round(r[1], 4) for r in rows]} (max "
              f"{max(r[1] for r in rows):.4f}), logit std "
              f"{statistics.median(r[2] for r in rows):.4f} (median), "
              f"top-1 over top-3 margin "
              f"{statistics.median(r[3] for r in rows):.4f} (median)")


# the preemption cell's pool: 160 pages preempt once in the first wave on
# phase 4's traffic, and 152 is the largest pool below it, in steps of 8,
# that preempts at least twice (PERF.md, section 4)
PREEMPT_PAGES = 152


def _preempt_line(res: dict, wave: str) -> str:
    """One wave's preemption, KV and latency numbers, for a print."""
    k, u, lat = ((res["preempt"], res["kv_util"], res["first_latency"])
                 if wave == "first" else
                 (res["warm_preempt"], res["warm_kv_util"], res["latency"]))
    return (f"{wave} wave: {k['preemptions']} preemptions of "
            f"{k['preempted_requests']} requests, {k['recompute_tokens']} "
            f"tokens recomputed, recomputed_ok {k['recomputed_ok']}, "
            f"{k['slot_failures']} slot failures; peak live slots "
            f"{u['peak_live_slots']}, mean KV util {u['mean_util']:.4f}; "
            f"TTFT p50 {lat['ttft_p50_s'] * 1e3:.1f} / p95 "
            f"{lat['ttft_p95_s'] * 1e3:.1f} ms, TPOT p50 "
            f"{lat['tpot_p50_s'] * 1e3:.2f} / p95 "
            f"{lat['tpot_p95_s'] * 1e3:.2f} ms, queue wait p50 "
            f"{lat['queue_wait_p50_s'] * 1e3:.1f} / p95 "
            f"{lat['queue_wait_p95_s'] * 1e3:.1f} ms")


def serve_preempt(torch, params, reference: dict) -> dict:
    """Optimistic admission on phase 4's paged traffic (full-width
    qwen2-0.5b, bf16, 16 requests of 64-512 tokens, 64 new tokens, batch
    8, max_len 1024, pages of 16, 8 steps a segment) on a pool smaller than
    its worst case, ``PREEMPT_PAGES``: graphed and eager; beside it,
    graphed, a ``ChaosInjector(fail_slot_at={3: "deepest"},
    check_invariants=True)`` run and reserve admission on the same pool;
    each run a first and a warm wave.  ``reference`` is phase 4's graphed
    paged run (reserve on 512 pages: no preemption).

    Gated: graphed = eager streams (both waves); the warm wave = the first
    (scheduling depends on counts, not time, so both waves preempt
    alike); at least 2 first-wave preemptions; ``recomputed_ok`` in both
    waves of the optimistic and chaos runs; one chaos slot failure;
    ``pool.check()`` with no page in use after each run; 64 in-vocab
    tokens a request; exact launches (resume joins are joins).  Printed:
    the preemption, KV-use and latency numbers of both waves, tok/s,
    graphs and capture seconds, and the optimistic and chaos streams
    against the reference's as counts of equal bf16 streams, with the
    float32 margin at each first difference of the optimistic run's.
    Returns the optimistic graphed run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run
    from repro_torch.serve.chaos import ChaosInjector
    cfg = get_config(ARCH)
    requests, max_new = 16, 64
    kw = dict(requests=requests, max_new=max_new, batch=8, max_len=1024,
              paged=True, page_size=16, sync_every=8, seed=0,
              prompt_len=(64, 513), dtype=torch.bfloat16)

    def one(label: str, graphs, **extra) -> tuple[dict, dict]:
        reset_counts()
        res = run(ARCH, params=params, graphs=graphs, device="cuda", **kw,
                  **extra)
        counts = read_counts()
        res["sync_every"] = kw["sync_every"]
        pool = res.pop("pool")
        pool.check()
        check(pool.used_pages == 0,
              f"preempt {label}: {pool.used_pages} pages still in use")
        check(sorted(res["results"]) == list(range(requests)),
              f"preempt {label}: missing requests")
        for rid, toks in res["results"].items():
            check(len(toks) == max_new
                  and all(0 <= t < cfg.vocab for t in toks),
                  f"preempt {label}: request {rid} returned {len(toks)} "
                  "tokens")
        check_serve_launches(res, counts, cfg, f"preempt {label}", True)
        check(counts["paged_prefill"] > 0 and counts["paged_decode"] > 0,
              f"preempt {label}: a paged kernel was not launched")
        print(f"[preempt] {ARCH} {label}: tok/s first wave "
              f"{res['tok_per_s']:.1f} (capture included), warm wave "
              f"{res['warm_tok_per_s']:.1f}; {res['graph_count']} graphs, "
              f"{res['capture_s']:.3f}s capturing; {res['joins']} joins, "
              f"{res['segments']} segments over both waves; "
              f"{_preempt_line(res, 'first')}; "
              f"{_preempt_line(res, 'warm')}; launches {counts}; {SMI}")
        return res, counts

    t0 = time.perf_counter()
    pages = PREEMPT_PAGES
    opt, launched = one(f"optimistic {pages} pages, graphs", None,
                        optimistic=True, total_pages=pages)
    eager, _ = one(f"optimistic {pages} pages, eager", False,
                   optimistic=True, total_pages=pages)
    chaos, _ = one(f"optimistic {pages} pages + slot failure, graphs", None,
                   optimistic=True, total_pages=pages,
                   chaos=ChaosInjector(fail_slot_at={3: "deepest"},
                                       check_invariants=True))
    res_same, _ = one(f"reserve {pages} pages, graphs", None,
                      total_pages=pages)
    for key in ("results", "warm_results"):
        diff = [rid for rid, toks in opt[key].items()
                if toks != eager[key][rid]]
        check(not diff, f"preempt optimistic: graphs and eager streams "
              f"differ ({key}) for requests {diff}")
    for res in (opt, eager):
        check(res["warm_results"] == res["results"],
              "preempt optimistic: the warm wave's tokens differ from the "
              "first wave's")
        check(res["preempt"]["preemptions"] >= 2,
              "preempt optimistic: fewer than 2 first-wave preemptions")
    for res in (opt, eager, chaos):
        check(res["preempt"]["recomputed_ok"]
              and res["warm_preempt"]["recomputed_ok"],
              "preempt: a preempted request did not complete")
    check(chaos["preempt"]["slot_failures"] == 1,
          f"preempt chaos: {chaos['preempt']['slot_failures']} slot "
          "failures, not 1")
    ref = reference["results"]
    u, r = opt["kv_util"], res_same["kv_util"]
    print(f"[preempt] {pages} pages, first wave, optimistic against reserve "
          f"on the same pool: peak live slots {u['peak_live_slots']} / "
          f"{r['peak_live_slots']}, mean KV util {u['mean_util']:.4f} / "
          f"{r['mean_util']:.4f}; tok/s first wave {opt['tok_per_s']:.1f} / "
          f"{res_same['tok_per_s']:.1f}, warm {opt['warm_tok_per_s']:.1f} / "
          f"{res_same['warm_tok_per_s']:.1f}; phase 4's paged run (512 "
          f"pages) {reference['tok_per_s']:.1f} / "
          f"{reference['warm_tok_per_s']:.1f}; {SMI}")
    print(f"[preempt] bfloat16 greedy streams equal (not gated): optimistic "
          f"vs reserve on 512 pages {_equal_streams(opt['results'], ref)}/"
          f"{requests}, reserve on {pages} vs 512 "
          f"{_equal_streams(res_same['results'], ref)}/{requests}, chaos "
          f"vs 512 {_equal_streams(chaos['results'], ref)}/{requests}; "
          f"chaos warm wave vs its first "
          f"{_equal_streams(chaos['warm_results'], chaos['results'])}/"
          f"{requests}")
    bf16_divergence(torch, params, cfg, opt["prompts"], opt["results"], ref,
                    f"[preempt] bfloat16 streams, optimistic on {pages} pages "
                    "against reserve on 512,")
    print(f"[preempt] phase 4's preemption runs took "
          f"{time.perf_counter() - t0:.1f}s")
    return launched


def _overload_line(res: dict, wave: str) -> str:
    """One wave's overload and SLO numbers, for a print."""
    o, slo = ((res["overload"], res["slo"]) if wave == "first"
              else (res["warm_overload"], res["warm_slo"]))
    ctl = o["controller"]
    by = {r: n for r, n in o["cancelled_by_reason"].items() if n}
    tis = {k: round(v, 4) for k, v in ctl["time_in_state"].items()}
    return (f"{wave} wave: transitions "
            f"{[(r, a, b) for r, a, b, _, _ in ctl['transitions']]}, end "
            f"{ctl['state']}, time in state {tis} s; {o['cancellations']} "
            f"cancelled {by}, {o['shed_requests']} shed, "
            f"{sum(r['status'] == 'RETRY_AFTER' for r in o['rejections'])} "
            f"RETRY_AFTER answers; deadline attainment "
            f"{o['deadline_attainment']:.4f} ({o['deadline_met']}/"
            f"{o['deadline_total']}); SLO attainment "
            f"{slo['slo_attainment']:.4f}, burn ttft "
            f"{slo['burn_rate_ttft']:.2f} / tpot {slo['burn_rate_tpot']:.2f}; "
            f"watchdog trips {o['watchdog_trips']}")


def _drained(res: dict, label: str) -> None:
    pool = res.pop("pool")
    pool.check()
    check(pool.used_pages == 0,
          f"{label}: {pool.used_pages} pages still in use")


def _complete(res: dict, cfg, requests: int, max_new: int,
              label: str) -> None:
    """Every request of both waves completed with ``max_new`` in-vocab
    tokens."""
    for key in ("results", "warm_results"):
        check(sorted(res[key]) == list(range(requests)),
              f"{label}: missing requests ({key})")
        for rid, toks in res[key].items():
            check(len(toks) == max_new
                  and all(0 <= t < cfg.vocab for t in toks),
                  f"{label}: request {rid} returned {len(toks)} tokens")


def serve_overload(torch, params, reference: dict, features: dict) -> None:
    """Overload protection and tracing on the paged path, full-width
    qwen2-0.5b in bf16, pages of 16, graphed; each run a first and a warm
    wave.  ``reference`` is phase 4's untraced paged run, ``features``
    the features cell's graphed streams.

    - traced: phase 4's traffic with ``telemetry`` and a Perfetto file.
      Gated: both waves' streams equal to ``reference``'s; the file
      parses and has ``traceEvents``; every SUBMIT rid has exactly one
      RETIRE; every request's ``attribution.explain`` partition holds;
      exact launches.  Printed: warm tok/s traced against untraced.
    - the forced ladder: the features cell's traffic with (b)'s features
      and ``overload_degrade_pressure=0.01``, up 1 round, down 50.  Gated:
      a transition, no cancellation, every request complete, a drained
      pool, exact launches split between the plain loop (decode kernel a
      step) and the verify loop (prefill kernel a step).  Printed: the
      streams equal to (b)'s and (a)'s.
    - the burst: optimistic admission on ``PREEMPT_PAGES`` pages with the
      controller on (its defaults), SLOs at ``reference``'s warm TTFT and
      TPOT p50, and chaos ``burst_at={2: 16}`` whose requests carry a
      deadline of that TTFT p50.  Gated: every request, the burst's
      included, ends in exactly one of results or cancelled; a drained
      pool; the chaos invariant checks each round; exact launches.
      Printed: transitions and time in state, sheds and RETRY_AFTER
      answers, cancels by reason, deadline attainment, warm tok/s and
      capture seconds.
    - the watchdog drill: phase 4's traffic with chaos ``stall_at={2:
      12}``, ``watchdog_rounds=8`` and a flight path.  Gated: a trip; the
      bundle written, its error a ``WatchdogStall``; the shed requests
      answered RETRY_AFTER; the rest completed; a drained pool; exact
      launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run
    from repro_torch.serve.attribution import explain
    from repro_torch.serve.chaos import ChaosInjector
    cfg = get_config(ARCH)
    requests, max_new = 16, 64
    kw = dict(requests=requests, max_new=max_new, batch=8, max_len=1024,
              paged=True, page_size=16, sync_every=8, seed=0,
              prompt_len=(64, 513), dtype=torch.bfloat16)
    t_all = time.perf_counter()
    secs = {}

    def one(label: str, **extra) -> tuple[dict, dict]:
        t0 = time.perf_counter()
        reset_counts()
        res = run(ARCH, params=params, device="cuda", **{**kw, **extra})
        counts = read_counts()
        secs[label] = time.perf_counter() - t0
        res["sync_every"] = kw["sync_every"]
        _drained(res, f"overload {label}")
        check_serve_launches(res, counts, cfg, f"overload {label}", True)
        return res, counts

    with tempfile.TemporaryDirectory() as tmp:
        trace_path = str(pathlib.Path(tmp) / "trace.json")
        traced, counts = one("traced", trace_out=trace_path)
        for key in ("results", "warm_results"):
            check(traced[key] == reference[key], f"overload traced: "
                  f"streams differ from the untraced run ({key})")
        with open(trace_path) as f:
            data = json.load(f)
        evs = data.get("traceEvents")
        check(isinstance(evs, list) and bool(evs),
              "overload traced: no traceEvents in the Perfetto file")
        submits, retires = {}, {}
        for e in evs:
            rid = (e.get("args") or {}).get("rid")
            if e.get("ph") == "i" and e.get("name") in ("SUBMIT", "RETIRE"):
                tally = submits if e["name"] == "SUBMIT" else retires
                tally[rid] = tally.get(rid, 0) + 1
        check(len(submits) == 2 * requests
              and all(retires.get(rid) == 1 for rid in submits),
              "overload traced: a submitted request does not retire once")
        tracer = traced["tracer"]
        for rid in tracer.rids():
            a = explain(tracer, rid)
            check(a is not None, f"overload traced: rid {rid} unexplained")
            try:
                a.check()
            except AssertionError as err:
                raise SmokeFailure(f"overload traced: {err}") from err
        dom = traced["attribution"]["dominant_ttft_component"]
        print(f"[overload] {ARCH} paged, traced, graphs: warm tok/s "
              f"{traced['warm_tok_per_s']:.1f} traced against "
              f"{reference['warm_tok_per_s']:.1f} untraced (phase 4), first "
              f"wave {traced['tok_per_s']:.1f} / {reference['tok_per_s']:.1f}"
              f"; {len(tracer.events)} events, {len(tracer.spans)} spans, "
              f"{len(evs)} Perfetto records; streams equal to the untraced "
              f"run's in both waves; attribution partitions exact for "
              f"{len(tracer.rids())} requests, dominant TTFT component "
              f"{dom} ({traced['attribution']['ttft'][dom]['share']:.3f}); "
              f"launches {counts}; {SMI}")
        del traced["tracer"], tracer

        ladder, counts = one(
            "forced ladder", shared_prefix=256, prompt_len=(64, 257),
            **FEATURES["b"], overload=True, overload_degrade_pressure=0.01,
            overload_up_rounds=1, overload_down_rounds=50)
        _complete(ladder, cfg, requests, max_new, "overload forced ladder")
        check(len(ladder["overload"]["controller"]["transitions"]) >= 1,
              "overload forced ladder: no transition")
        check(not ladder["cancelled"] and not ladder["warm_cancelled"],
              "overload forced ladder: a request was cancelled")
        print(f"[overload] {ARCH} features (b) + forced ladder, graphs: "
              f"tok/s first wave {ladder['tok_per_s']:.1f}, warm "
              f"{ladder['warm_tok_per_s']:.1f}; {ladder['segments']} "
              f"segments over both waves, {ladder['spec_segments']} of "
              f"them verify, {ladder['joins']} joins; "
              f"{_overload_line(ladder, 'first')}; "
              f"{_overload_line(ladder, 'warm')}; bfloat16 streams equal "
              f"(not gated) to (b)'s "
              f"{_equal_streams(ladder['results'], features['b'])}/"
              f"{requests}, to (a)'s "
              f"{_equal_streams(ladder['results'], features['a'])}/"
              f"{requests}; launches {counts}; {SMI}")

        lat = reference["latency"]
        ttft, tpot = lat["ttft_p50_s"], lat["tpot_p50_s"]
        chaos = ChaosInjector(burst_at={2: 16}, burst_deadline_s=ttft,
                              check_invariants=True)
        burst, counts = one("burst", optimistic=True,
                            total_pages=PREEMPT_PAGES, chaos=chaos,
                            overload=True, ttft_slo=ttft, tpot_slo=tpot)
        n_burst = sum(n for _, kind, n in chaos.events if kind == "burst")
        check(n_burst == 16, f"overload burst: {n_burst} burst requests")
        rid0 = ChaosInjector.BURST_RID0
        for wave, want, cancelled in (
                ("first", set(range(requests))
                 | set(range(rid0, rid0 + n_burst)), burst["cancelled"]),
                ("warm", set(range(requests, 2 * requests)),
                 burst["warm_cancelled"])):
            done = {rid for rid in burst["all_results"] if rid in want}
            check(done | set(cancelled) == want
                  and not done & set(cancelled),
                  f"overload burst: the {wave} wave's requests are not "
                  "each in exactly one of results or cancelled")
        print(f"[overload] {ARCH} optimistic {PREEMPT_PAGES} pages + "
              f"controller + burst of {n_burst} (deadline {ttft * 1e3:.1f}"
              f" ms, SLOs ttft {ttft * 1e3:.1f} / tpot {tpot * 1e3:.2f} ms)"
              f", graphs: tok/s first wave {burst['tok_per_s']:.1f}, warm "
              f"{burst['warm_tok_per_s']:.1f}, {burst['capture_s']:.3f}s "
              f"capturing; completed {len(burst['results'])}/{requests} "
              f"+ burst {sum(r >= rid0 for r in burst['all_results'])}/"
              f"{n_burst} first wave, {len(burst['warm_results'])}/"
              f"{requests} warm; {_overload_line(burst, 'first')}; "
              f"{_overload_line(burst, 'warm')}; preemptions "
              f"{burst['preempt']['preemptions']} / "
              f"{burst['warm_preempt']['preemptions']}; launches {counts}; "
              f"{SMI}")

        bundle_path = pathlib.Path(tmp) / "flight.json"
        drill, counts = one("watchdog drill",
                            chaos=ChaosInjector(stall_at={2: 12},
                                                check_invariants=True),
                            watchdog_rounds=8, flight_path=str(bundle_path))
        o = drill["overload"]
        check(o["watchdog_trips"] >= 1, "overload drill: no watchdog trip")
        check(bundle_path.exists(), "overload drill: no flight bundle")
        bundle = json.loads(bundle_path.read_text())
        check(bundle["error"].startswith("WatchdogStall"),
              f"overload drill: bundle error {bundle['error'][:60]!r}")
        shed = {r["rid"] for r in o["rejections"]
                if r["status"] == "RETRY_AFTER"}
        check(bool(shed) and shed == set(drill["cancelled"]),
              "overload drill: the shed requests are not the RETRY_AFTER "
              "answers")
        check(set(drill["results"]) | shed == set(range(requests))
              and sorted(drill["warm_results"]) == list(range(requests)),
              "overload drill: a request neither completed nor was shed")
        print(f"[overload] {ARCH} watchdog drill (stall 12 rounds from "
              f"round 2, watchdog 8), graphs: {o['watchdog_trips']} trips, "
              f"shed {sorted(shed)} with RETRY_AFTER, {len(drill['results'])}"
              f"/{requests} completed; bundle {bundle['error'][:48]!r}..., "
              f"{len(bundle['events'])} events, round {bundle['round']}, "
              f"queue {bundle['queue']}; warm tok/s "
              f"{drill['warm_tok_per_s']:.1f}; launches {counts}")
    print(f"[overload] phase 4's overload runs took "
          f"{time.perf_counter() - t_all:.1f}s ("
          + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()) + ")")


def autotune_phase(torch, params) -> dict:
    """The ``[autotune]`` phase.  (1) A bounded sweep (budget 8, 3 replays
    a candidate) of decode, prefill and verify at full-width qwen2-0.5b's
    and moonshot-v1-16b-a3b's geometry in bfloat16, at the serve cells'
    shapes, through ``repro_torch.launch.autotune.sweep`` (nothing
    saved): each candidate's device ms, parity error and bit-exactness
    printed, the winner no slower than the default, and the committed
    entries loaded by the policy for all six (op, geometry) keys.  (2) One
    eager paged qwen serve (phase 4's traffic, 8 requests) with the
    attention telemetry on: each op's calls equal to its kernel's launches
    over the run, none captured, achieved GB/s under 1.05 x 3,350, the
    amenability verdicts printed.  Returns {geometry: {op: result}} for
    the kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn.ops import DecodeAttnPolicy
    from repro_torch.kernels.paged_attn import autotune as at
    from repro_torch.launch.autotune import geometry, sweep
    from repro_torch.launch.serve import run
    t0 = time.perf_counter()
    swept = {}
    for arch in (ARCH, MOE_ARCH):
        swept.update(sweep(arch, budget=8, reps=3, device="cuda",
                           dtype=torch.bfloat16, save=False))
    committed = at.load_entries()
    pol = DecodeAttnPolicy()
    for geo_key, res in swept.items():
        for op, r in res.items():
            check(r["winner_ms"] <= r["default_ms"],
                  f"autotune {geo_key} {op}: the winner is slower than the "
                  "default")
            check(all(row["max_abs_diff"] <= at.PARITY_TOL[torch.bfloat16]
                      for row in r["candidates"]),
                  f"autotune {geo_key} {op}: a measured candidate fails "
                  "the parity gate")
            ent = committed.get(r["key"])
            check(isinstance(ent, dict), f"autotune: no committed entry "
                  f"{r['key']}")
            geom = geometry(ARCH if "hkv2" in geo_key else MOE_ARCH, PS)
            loaded = pol.tuned_config(op, hq=geom.hq, hkv=geom.hkv,
                                      d=geom.d, page_size=PS)
            check(loaded == ent["config"], f"autotune: the policy does not "
                  f"load the committed entry {r['key']}")
            print(f"[autotune] {r['key']}: committed {ent['config']} "
                  f"({ent['ms']:.5f} ms against {ent['default_ms']:.5f} "
                  f"ms; {ent['card']}), this run's winner {r['winner']} "
                  f"({r['winner_ms']:.5f} against {r['default_ms']:.5f} "
                  f"ms)")
    t_sweep = time.perf_counter() - t0

    cfg = get_config(ARCH)
    reset_counts()
    res = run(ARCH, params=params, graphs=False, device="cuda", paged=True,
              requests=8, max_new=16, batch=8, max_len=1024, page_size=16,
              sync_every=8, prompt_len=(64, 513), seed=0,
              dtype=torch.bfloat16, attn_telemetry_on=True)
    counts = read_counts()
    calls = {}
    for wave in (res["attn"], res["warm_attn"]):
        for key, row in wave["stats"].items():
            calls[key] = calls.get(key, 0) + row["calls"]
            check(row["traced_calls"] == 0, f"attention telemetry {key}: "
                  "a captured call in an eager run")
            check(row["achieved_gbps"] < 1.05 * HBM_BYTES_PER_S / 1e9,
                  f"attention telemetry {key}: {row['achieved_gbps']:.1f} "
                  "GB/s achieved, above the card's rate")
    print(f"[autotune] eager paged {cfg.name} wave with attention "
          f"telemetry: calls {calls}; launches {counts}; verdicts "
          f"{res['attn']['verdicts']}; {SMI}")
    check(calls.get("decode.kernel") == counts["paged_decode"]
          and calls.get("prefill.kernel") == counts["paged_prefill"]
          and set(calls) == {"decode.kernel", "prefill.kernel"},
          "attention telemetry: an op's calls differ from its kernel's "
          "launches")
    print(f"[autotune] phase took {time.perf_counter() - t0:.1f}s (sweep "
          f"{t_sweep:.1f}s)")
    return swept


def plain_route_agreement(torch, params, kw) -> None:
    """float32 on the card, paged: ``attn_mode="plain"`` (gather, then
    plain PyTorch attention) against ``"kernel"`` (graphs): equal greedy
    streams, joins, segments and admit order in both waves."""
    from repro_torch.launch.serve import run
    got = {mode: run(ARCH, device="cuda", params=params, paged=True,
                     attn_mode=mode, **kw) for mode in ("plain", "kernel")}
    same = {key: got["plain"][key] == got["kernel"][key]
            for key in ("results", "warm_results", "joins", "segments")}
    print(f"[autotune] float32 paged, attn_mode plain vs kernel: "
          f"{sum(same.values())}/{len(same)} of streams, warm streams, "
          f"joins and segments equal")
    check(all(same.values()), f"plain and kernel routes differ: {same}")


def dense_join_rows(torch) -> None:
    """What a dense join's prefill costs at full-width qwen, bf16: the
    joining rows alone (J of them, which a dense-MLP model would allow)
    against all 8 rows (what ``make_join`` prefills, as JAX does), at the
    join's widths 128 and 512."""
    from repro_torch.configs import get_config
    from repro_torch.models.init import cast_for_serving
    from repro_torch.models.model_zoo import Model
    cfg = get_config(ARCH)
    model = Model(cfg)
    params = cast_for_serving(model.init(SEED, device="cuda",
                                         dtype=torch.bfloat16),
                              torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for width in (128, 512):
        toks = torch.randint(0, cfg.vocab, (8, width), generator=gen,
                             device="cuda")
        last = torch.full((8,), width - 1, dtype=torch.long, device="cuda")
        ms = {j: time_ms(lambda i, j=j: model.prefill(
            params, {"tokens": toks[:j]}, width, dtype=torch.bfloat16,
            last_pos=last[:j]), 3, reps=3) for j in (1, 4, 8)}
        print(f"[join] {ARCH} dense join prefill at width {width}: joining "
              f"rows only, J 1 {ms[1]:.3f} ms, J 4 {ms[4]:.3f} ms; every "
              f"row (8) {ms[8]:.3f} ms")
        check(all(math.isfinite(v) for v in ms.values()),
              "dense join timing is not finite")


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
        eager = run(ARCH, device="cuda", params=params, paged=paged,
                    graphs=False, **kw)["results"]
        on_cpu = run(ARCH, device="cpu", params=cpu_params, paged=paged,
                     **kw)
        prompts, on_cpu = on_cpu["prompts"], on_cpu["results"]
        ties = sum(_near_tie(torch, cpu_params, cfg, prompts[rid],
                             on_card[rid], want, f"{layout} request {rid}")
                   for rid, want in on_cpu.items())
        print(f"[agree] float32 greedy streams, {layout}, CUDA kernels "
              f"(graphs) vs CPU plain path: {len(on_cpu) - ties}/"
              f"{len(on_cpu)} equal, {ties} at near-ties")
        ties = sum(_near_tie(torch, cpu_params, cfg, prompts[rid],
                             on_card[rid], want, f"{layout} graphs vs eager "
                             f"request {rid}")
                   for rid, want in eager.items())
        print(f"[agree] float32 greedy streams on the card, {layout}, "
              f"graphs vs eager: {len(eager) - ties}/{len(eager)} equal, "
              f"{ties} at near-ties")
        streams[layout] = on_card
    ties = sum(_near_tie(torch, cpu_params, cfg, prompts[rid],
                         streams["dense"][rid], want, f"dense vs paged "
                         f"request {rid}")
               for rid, want in streams["paged"].items())
    print(f"[agree] float32 greedy streams on the card, dense kernel vs "
          f"paged kernels: {len(prompts) - ties}/{len(prompts)} equal, "
          f"{ties} at near-ties")
    plain_route_agreement(torch, params, kw)
    feature_agreement(torch, params, cpu_params, kw)
    preempt_agreement(torch, params, cpu_params)
    overload_agreement(torch, params, cpu_params, kw)


def _serve_once(torch, cfg, params, prompts: dict, graphs=None, chaos=None,
                **scfg):
    """One wave of ``prompts`` (16 new tokens each) through a fresh paged
    ``Batcher`` in float32 (batch 2, max_len 128, pages of 16, 4 steps a
    segment) on the device of ``params``; returns the batcher and the
    kernel launches of its run."""
    from repro_torch.models.model_zoo import Model
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import Batcher
    b = Batcher(Model(cfg), params, ServeConfig(
        max_len=128, batch=2, dtype=torch.float32, sync_every=4, paged=True,
        page_size=16, **scfg), graphs=graphs, chaos=chaos)
    for rid, p in prompts.items():
        b.submit(rid, p)
    reset_counts()
    b.run(max_new=16)
    return b, read_counts()


def preempt_agreement(torch, params, cpu_params) -> None:
    """float32, optimistic admission on a 5-page pool, one wave of 4
    seeded requests of 16-40 tokens (16 new tokens, batch 2, pages of 16:
    the first two admissions need 4 pages optimistic and 6 reserved, so
    the run preempts): plain, with a ``fail_slot_at={3: "deepest"}``
    chaos injector, and with the prefix cache (the resumes match their
    own pages).  Each the card (graphed) against the CPU plain path,
    graphed against eager on the card, and against reserve admission on
    an ample pool on the card: equal streams or a first difference at a
    near-tie; where the card's and the CPU's streams are all equal, their
    ``preempt_stats`` (events included) are equal too.  Gated:
    preemptions, every preempted request completed, one slot failure
    with chaos, skipped prefill with the prefix cache, exact launches, a
    drained pool."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serve.chaos import ChaosInjector
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    prompts = {rid: rng.integers(0, cfg.vocab,
                                 size=int(rng.integers(16, 40))).tolist()
               for rid in range(4)}
    ample, _ = _serve_once(torch, cfg, params, prompts)
    variants = {"plain": ({}, None),
                "slot failure": ({}, {3: "deepest"}),
                "prefix cache": (dict(prefix_cache=True), None)}
    for name, (feats, fail) in variants.items():
        def go(p, graphs=None):
            chaos = (ChaosInjector(fail_slot_at=fail, check_invariants=True)
                     if fail else None)
            b, counts = _serve_once(torch, cfg, p, prompts, graphs=graphs,
                                    chaos=chaos, total_pages=5,
                                    admission_mode="optimistic", **feats)
            b.pool.check()
            check(b.pool.used_pages == 0,
                  f"preempt agreement {name}: pages still in use")
            return b, counts
        on_card, counts = go(params)
        check_serve_launches({"joins": on_card.joins,
                              "segments": on_card.segments,
                              "sync_every": 4}, counts, cfg,
                             f"preempt agreement {name}", True)
        eager, _ = go(params, graphs=False)
        on_cpu, _ = go(cpu_params)
        k = on_card.preempt_stats()
        check(k["preemptions"] > 0 and k["recomputed_ok"],
              f"preempt agreement {name}: no preemption, or one that did "
              "not complete")
        check(not fail or k["slot_failures"] == 1,
              f"preempt agreement {name}: {k['slot_failures']} slot "
              "failures")
        skipped = on_card.prefix_stats()["prefill_skipped"]
        check(not feats or skipped > 0,
              f"preempt agreement {name}: no resume matched its pages")
        ties = {}
        for other, want in (("CPU", on_cpu), ("eager", eager),
                            ("reserve", ample)):
            ties[other] = sum(
                _near_tie(torch, cpu_params, cfg, prompts[rid],
                          on_card.results[rid], toks,
                          f"preempt {name} vs {other} request {rid}")
                for rid, toks in want.results.items())
        if ties["CPU"] == 0:
            check(k == on_cpu.preempt_stats(),
                  f"preempt agreement {name}: preempt_stats differ, card "
                  f"{k} vs CPU {on_cpu.preempt_stats()}")
        n = len(prompts)
        print(f"[agree] float32 greedy streams, optimistic on 5 pages, "
              f"{name}: CUDA kernels (graphs) vs CPU plain path "
              f"{n - ties['CPU']}/{n} equal, graphs vs eager "
              f"{n - ties['eager']}/{n}, vs reserve on an ample pool "
              f"{n - ties['reserve']}/{n} (the rest at near-ties); "
              f"preempt_stats "
              f"{'equal' if ties['CPU'] == 0 else 'not compared'}: "
              f"{k['preemptions']} preemptions, {k['recompute_tokens']} "
              f"tokens recomputed, {k['slot_failures']} slot failures, "
              f"prefill skipped {skipped}; launches {counts}")
    print(f"[agree] the optimistic agreement runs took "
          f"{time.perf_counter() - t0:.1f}s")


def ladder_agreement(torch, params, cpu_params, cfg, name: str,
                     shared: dict, sync_every: int) -> None:
    """One forced-ladder configuration of ``overload_agreement``: the card
    graphed against the CPU, eagerly and traced."""
    from repro_torch.launch.serve import run

    def ladder_run(p, device, **extra) -> dict:
        reset_counts()
        res = run(ARCH, device=device, params=p, **shared, **extra)
        res["counts"] = read_counts()
        res["sync_every"] = sync_every
        _drained(res, f"overload agreement ladder {name} {device}")
        res.pop("tracer")
        return res

    runs = {"card": ladder_run(params, "cuda"),
            "eager": ladder_run(params, "cuda", graphs=False),
            "traced": ladder_run(params, "cuda", telemetry=True),
            "CPU": ladder_run(cpu_params, "cpu")}
    card = runs["card"]
    check_serve_launches(card, card["counts"], cfg,
                         f"overload agreement ladder {name}", True)
    ctl = card["overload"]["controller"]
    check(len(ctl["transitions"]) >= 1 and not card["cancelled"],
          f"overload agreement ladder {name}: no transition, or a "
          "cancellation")
    check(shared.get("prefill_chunk") is not None
          or 0 < card["spec_segments"] < card["segments"],
          f"overload agreement ladder {name}: the verify and the plain "
          "loop did not both run")
    prompts = card["prompts"]
    for other in ("CPU", "eager", "traced"):
        want = runs[other]
        for key in ("results", "warm_results"):
            for rid, toks in want[key].items():
                _near_tie(torch, cpu_params, cfg, prompts[rid],
                          card[key][rid], toks,
                          f"ladder {name} {other} {key} request {rid}")
        for key in ("overload", "warm_overload"):
            got, exp = card[key], want[key]
            check(got["controller"]["transitions"]
                  == exp["controller"]["transitions"]
                  and got["rejections"] == exp["rejections"]
                  and got["cancelled_by_reason"]
                  == exp["cancelled_by_reason"],
                  f"overload agreement ladder {name}: {key} differs, card "
                  f"against {other}")
        check(card["cancelled"] == want["cancelled"]
              and card["warm_cancelled"] == want["warm_cancelled"]
              and card["spec_segments"] == want["spec_segments"],
              f"overload agreement ladder {name}: cancellations or verify "
              f"segments differ, card against {other}")
    print(f"[agree] float32 forced ladder ({name}, speculation k 3): card "
          f"graphed = CPU = eager = traced in streams (near-ties allowed), "
          f"transitions "
          f"{[(r, a, b) for r, a, b, _, _ in ctl['transitions']]}, no "
          f"cancellation; {card['segments']} segments, "
          f"{card['spec_segments']} verify; {card['graph_count']} graphs; "
          f"launches {card['counts']}")


def overload_agreement(torch, params, cpu_params, kw) -> None:
    """float32 at phase 5's size: the forced ladder
    (``overload_degrade_pressure=0.01``, up 1 round, down 50, speculation
    k 3) on phase 5's traffic behind a 32-token shared prefix, with the
    prefix cache and chunks of 16 (nothing decodes before the ladder
    sheds speculation) and with speculation alone (the first segment
    verifies, then the ladder sheds speculation and the plain loop's
    graph is captured mid-run), through ``launch.serve.run``; and the
    watchdog drill (the optimistic agreement's 4 requests, reserve
    admission, chaos ``stall_at={2: 12}``, ``watchdog_rounds=8``) through
    the ``Batcher``.  Each on the card graphed, eagerly and traced, and
    on the CPU.  Gated: the streams equal (or a first difference at a
    shown near-tie), and the transitions, cancellations and rejections
    equal, card against CPU, graphed against eager and traced against
    untraced; a transition, no cancellation and exact launches in the
    ladder, and both loops run in the speculation-alone ladder; a trip,
    a shed answered RETRY_AFTER and a ``WatchdogStall`` bundle in the
    drill; drained pools."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serve.chaos import ChaosInjector
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    ladder = dict(kw, paged=True, shared_prefix=32, speculate_k=3,
                  overload=True, overload_degrade_pressure=0.01,
                  overload_up_rounds=1, overload_down_rounds=50)
    for name, feats in (("features", dict(prefix_cache=True,
                                          prefill_chunk=16)),
                        ("speculation alone", {})):
        ladder_agreement(torch, params, cpu_params, cfg, name,
                         dict(ladder, **feats), kw["sync_every"])

    rng = np.random.default_rng(1)
    prompts = {rid: rng.integers(0, cfg.vocab,
                                 size=int(rng.integers(16, 40))).tolist()
               for rid in range(4)}

    def drill(p, graphs=None, telemetry=False):
        b, counts = _serve_once(
            torch, cfg, p, prompts, graphs=graphs,
            chaos=ChaosInjector(stall_at={2: 12}, check_invariants=True),
            watchdog_rounds=8, telemetry=telemetry)
        b.pool.check()
        check(b.pool.used_pages == 0,
              "overload agreement drill: pages still in use")
        return b, counts

    drills = {"card": drill(params), "eager": drill(params, graphs=False),
              "traced": drill(params, telemetry=True),
              "CPU": drill(cpu_params)}
    b, counts = drills["card"]
    o = b.overload_stats()
    check(o["watchdog_trips"] >= 1 and o["rejections"]
          and all(r["status"] == "RETRY_AFTER" for r in o["rejections"]),
          "overload agreement drill: no trip, or no RETRY_AFTER shed")
    check(b.last_flight_bundle is not None and b.last_flight_bundle[
        "error"].startswith("WatchdogStall"),
          "overload agreement drill: no WatchdogStall bundle")
    check_serve_launches({"joins": b.joins, "segments": b.segments,
                          "sync_every": 4}, counts, cfg,
                         "overload agreement drill", True)
    for other in ("CPU", "eager", "traced"):
        ob = drills[other][0]
        check(b.cancelled == ob.cancelled and b.rejections == ob.rejections
              and b.overload_stats()["watchdog_trips"]
              == ob.overload_stats()["watchdog_trips"]
              and set(b.results) == set(ob.results),
              f"overload agreement drill: card against {other}: "
              "cancellations, rejections or trips differ")
        for rid, toks in ob.results.items():
            _near_tie(torch, cpu_params, cfg, prompts[rid],
                      b.results[rid], toks, f"drill {other} request {rid}")
        bundle, obundle = b.last_flight_bundle, ob.last_flight_bundle
        check(all(bundle[k] == obundle[k]
                  for k in ("slot_table", "queue", "pool", "round")),
              f"overload agreement drill: the flight bundles differ, card "
              f"against {other}")
    print(f"[agree] float32 watchdog drill: card graphed = CPU = eager = "
          f"traced in streams, cancellations {b.cancelled}, rejections "
          f"{[(r['rid'], r['status'], r['round']) for r in b.rejections]}, "
          f"{o['watchdog_trips']} trips and the bundle's slot table, queue "
          f"and pool; launches {counts}")
    print(f"[agree] the overload agreement runs took "
          f"{time.perf_counter() - t0:.1f}s")


def feature_agreement(torch, params, cpu_params, kw) -> None:
    """float32, phase 5's traffic behind a 32-token shared prefix, paged,
    with the prefix cache, chunks of 16 and speculation (k 3): the card
    (graphed) against the CPU plain path, and features on against off on
    the card.  Equal streams, or a first difference at a near-tie; where
    the card's and the CPU's streams are all equal, their prefix, spec
    and chunk statistics are equal too (both waves)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run
    cfg = get_config(ARCH)
    shared = dict(kw, paged=True, shared_prefix=32)
    feats = dict(prefix_cache=True, prefill_chunk=16, speculate_k=3)
    reset_counts()
    on_card = run(ARCH, device="cuda", params=params, **shared, **feats)
    counts = read_counts()
    on_card["sync_every"] = kw["sync_every"]
    check_serve_launches(on_card, counts, cfg, "feature agreement", True,
                         spec=True)
    on_cpu = run(ARCH, device="cpu", params=cpu_params, **shared, **feats)
    off_card = run(ARCH, device="cuda", params=params, **shared)
    prompts = on_cpu["prompts"]
    ties = sum(_near_tie(torch, cpu_params, cfg, prompts[rid],
                         on_card["results"][rid], want,
                         f"features request {rid}")
               for rid, want in on_cpu["results"].items())
    same = ties == 0 and on_card["warm_results"] == on_cpu["warm_results"]
    stats = ("prefix", "spec", "warm_prefix", "warm_spec")
    if same:
        for key in stats:
            check(on_card[key] == on_cpu[key],
                  f"feature agreement: {key} differs, card {on_card[key]} "
                  f"vs CPU {on_cpu[key]}")
        for key in ("joins", "chunk_joins", "budget_deferrals"):
            check(on_card["first_join"][key] == on_cpu["first_join"][key]
                  and on_card["join"][key] == on_cpu["join"][key],
                  f"feature agreement: join {key} differs")
    pre, sp, join = on_card["prefix"], on_card["spec"], on_card["first_join"]
    print(f"[agree] float32 greedy streams, paged with the prefix cache, "
          f"chunks of 16 and speculation k 3, CUDA kernels (graphs) vs CPU "
          f"plain path: {len(prompts) - ties}/{len(prompts)} equal, {ties} "
          f"at near-ties; statistics "
          f"{'equal' if same else 'not compared (streams differ)'}: prefix "
          f"hits {pre['hits']}/{pre['admits']}, skipped "
          f"{pre['prefill_skipped']}, {join['chunk_joins']} chunk "
          f"continuations, {sp['steps']} verify steps, acceptance "
          f"{sp['acceptance_rate']:.3f}; launches {counts}")
    check(pre["hits"] > 0 and join["chunk_joins"] > 0 and sp["steps"] > 0,
          "feature agreement: a feature did not act")
    ties = sum(_near_tie(torch, cpu_params, cfg, prompts[rid],
                         on_card["results"][rid], want,
                         f"features on vs off request {rid}")
               for rid, want in off_card["results"].items())
    print(f"[agree] float32 greedy streams on the card, features on vs "
          f"off: {len(prompts) - ties}/{len(prompts)} equal, {ties} at "
          f"near-ties")


def moe_cut(layers_moe: int):
    """Full-width moonshot with its depth cut to the dense layer and
    ``layers_moe`` MoE layers (every width, the experts and the vocab
    kept)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import BlockKind, Segment
    cfg = get_config(MOE_ARCH)
    return dataclasses.replace(
        cfg, n_layers=1 + layers_moe,
        segments=(Segment(BlockKind.DENSE, 1),
                  Segment(BlockKind.MOE, layers_moe)))


def moe_agreement(torch) -> None:
    """float32, full-width moonshot cut to 1 dense + 2 MoE layers, seeded
    weights: each layout's CUDA kernels (the attention kernels at D 128,
    G 1 and the grouped expert GEMM) against its CPU plain path, and the
    dense layout against the paged one on the card.  Batch 2 with prompts
    of 16-40 tokens gives capacities of 1 to 15, so choices drop."""
    from repro_torch.launch.serve import run
    from repro_torch.models.init import init_params
    cfg = moe_cut(2)
    params = init_params(cfg, 1, device="cuda")
    cpu_params = _to(torch, params, "cpu")
    kw = dict(requests=3, max_new=8, batch=2, max_len=128, page_size=16,
              sync_every=4, seed=1, prompt_len=(16, 40),
              dtype=torch.float32)
    streams = {}
    for paged in (True, False):
        layout = "paged" if paged else "dense"
        runs = {}
        for mode, graphs in (("graphs", None), ("eager", False)):
            reset_counts()
            res = run(cfg, device="cuda", params=params, paged=paged,
                      graphs=graphs, **kw)
            counts = read_counts()
            calls = res["joins"] + kw["sync_every"] * res["segments"]
            check(counts["group_gemm"] == 3 * 2 * calls,
                  f"moe agreement {layout} {mode}: group_gemm launches "
                  f"{counts['group_gemm']} != 3 x 2 MoE layers x {calls} "
                  "calls")
            check((res["graph_count"] > 0) == (mode == "graphs"),
                  f"moe agreement {layout} {mode}: {res['graph_count']} "
                  "graphs")
            runs[mode] = res["results"]
        on_card = runs["graphs"]
        on_cpu = run(cfg, device="cpu", params=cpu_params, paged=paged,
                     **kw)
        prompts, on_cpu = on_cpu["prompts"], on_cpu["results"]
        ties = sum(_near_tie(torch, cpu_params, cfg, prompts[rid],
                             on_card[rid], want, f"moe {layout} request "
                             f"{rid}")
                   for rid, want in on_cpu.items())
        print(f"[agree] moe float32 greedy streams, {layout}, CUDA kernels "
              f"(graphs) vs CPU plain path: {len(on_cpu) - ties}/"
              f"{len(on_cpu)} equal, {ties} at near-ties; launches {counts}")
        ties = sum(_near_tie(torch, cpu_params, cfg, prompts[rid],
                             on_card[rid], want, f"moe {layout} graphs vs "
                             f"eager request {rid}")
                   for rid, want in runs["eager"].items())
        print(f"[agree] moe float32 greedy streams on the card, {layout}, "
              f"graphs vs eager: {len(on_cpu) - ties}/{len(on_cpu)} equal, "
              f"{ties} at near-ties")
        streams[layout] = on_card
    ties = sum(_near_tie(torch, cpu_params, cfg, prompts[rid],
                         streams["dense"][rid], want, f"moe dense vs paged "
                         f"request {rid}")
               for rid, want in streams["paged"].items())
    print(f"[agree] moe float32 greedy streams on the card, dense vs paged: "
          f"{len(prompts) - ties}/{len(prompts)} equal, {ties} at "
          f"near-ties")


def moe_serve(torch) -> dict:
    """Full-width, full-depth moonshot (48 layers: 1 dense + 47 MoE;
    seeded bfloat16 weights built in place once) through
    ``repro_torch.launch.serve.run``, paged with pages of 16: 16 requests,
    prompts of 64-512 tokens, 64 new tokens each, batch 8, max_len 1024,
    8 steps per segment; with graphs (the main path) and eagerly, each a
    first and a warm wave.  Returns the graphed run's kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import Model
    cfg = get_config(MOE_ARCH)
    requests, max_new = 16, 64
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = Model(cfg).init(0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    runs = serve_both(torch, MOE_ARCH, params, f"moe paged {cfg.name}",
                      requests=requests, max_new=max_new, batch=8,
                      max_len=1024, paged=True, page_size=16, sync_every=8,
                      seed=0, prompt_len=(64, 513), dtype=torch.bfloat16)
    n_moe = sum(s.count for s in cfg.resolved_segments()
                if s.kind.value == "moe")
    for mode, (res, counts) in runs.items():
        steps = res["sync_every"] * res["segments"]
        check(sorted(res["results"]) == list(range(requests)),
              f"serve moe {mode}: missing requests")
        for rid, toks in res["results"].items():
            check(len(toks) == max_new
                  and all(0 <= t < cfg.vocab for t in toks),
                  f"serve moe {mode}: request {rid} returned {len(toks)} "
                  "tokens")
        check(counts["group_gemm"] == 3 * n_moe * (res["joins"] + steps),
              f"serve moe {mode}: group_gemm launches != 3 x MoE layers x "
              "(joins + decode steps)")
        check_serve_launches(res, counts, cfg, f"moe {mode}", True)
    res, counts = runs["graphs"]
    lens = sorted(len(p) for p in res["prompts"].values())
    print(f"[serve] moe paged {cfg.name}: prompts {lens[0]}-{lens[-1]} "
          f"tokens; weights built in {built:.1f}s; peak device memory with "
          f"graphs {res['peak_gib']:.2f} GiB, eager "
          f"{runs['eager'][0]['peak_gib']:.2f} GiB; {SMI}")
    del runs, res, params
    torch.cuda.empty_cache()
    return counts


def deepseek_cut():
    """Full-width deepseek-v3 with its depth cut to 3 dense + 1 MoE layer
    of 61 (every width, all 256 experts, the vocab and the MTP block
    kept), built as :func:`moe_cut` builds moonshot's cut."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import BlockKind, Segment
    cfg = get_config(MLA_ARCH)
    return dataclasses.replace(
        cfg, n_layers=4, segments=(Segment(BlockKind.DENSE, 3),
                                   Segment(BlockKind.MOE, 1)))


def check_moe_launches(res: dict, counts: dict, cfg, label: str) -> None:
    """The grouped GEMM's launches of one serve run, exact: 3 (gate, up,
    down) a MoE layer for each forward call, a join, a chunk or a decode
    or verify step."""
    n_moe = sum(seg.count for seg in cfg.resolved_segments()
                if seg.kind.value == "moe")
    calls = res["joins"] + res["sync_every"] * res["segments"]
    check(counts["group_gemm"] == 3 * n_moe * calls,
          f"serve {label}: group_gemm launches {counts['group_gemm']} != 3 "
          f"x {n_moe} MoE layers x {calls} calls")


def _family_line(label: str, res: dict, counts: dict, extra: str,
                 tag: str = "families") -> None:
    lat = res["latency"]
    print(f"[{tag}] {label}, graphs: tok/s first wave "
          f"{res['tok_per_s']:.1f} (capture included), warm wave "
          f"{res['warm_tok_per_s']:.1f}; TTFT p50 "
          f"{lat['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
          f"{lat['tpot_p50_s'] * 1e3:.2f} ms (warm); {res['graph_count']} "
          f"graphs, {res['capture_s']:.3f}s capturing; {res['joins']} joins, "
          f"{res['segments']} segments over both waves; {extra}; peak "
          f"device memory {res['peak_gib']:.2f} GiB (weights "
          f"{res['weights_gib']:.2f} GiB, {res['held_gib']:.2f} GiB held "
          f"before the build); launches {counts}; {SMI}")


def _family_run(torch, cfg, params, held, label, requests, max_new,
                paged=True, **kw):
    """One graphed serve run (a first and a warm wave) of ``cfg`` on the
    card, paged (or on dense stripes), with its launches and peak device
    memory (``held``: the bytes allocated before ``params`` were built,
    which the peak includes); gated: every request answered with
    ``max_new`` in-vocab tokens, the warm wave's streams the first's (with
    the prefix cache off)."""
    from repro_torch.launch.serve import run
    weights = torch.cuda.memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = run(cfg, params=params, device="cuda", requests=requests,
              max_new=max_new, batch=8, max_len=1024, paged=paged,
              page_size=16, sync_every=8, seed=0, dtype=torch.bfloat16,
              **kw)
    counts = read_counts()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["weights_gib"] = weights / 2**30
    res["held_gib"] = held / 2**30
    res["sync_every"] = 8
    check(res["graphs"] and res["graph_count"] > 0,
          f"serve {label}: no decode graph")
    check(sorted(res["results"]) == list(range(requests)),
          f"serve {label}: missing requests")
    for rid, toks in res["results"].items():
        check(len(toks) == max_new and all(0 <= t < cfg.vocab for t in toks),
              f"serve {label}: request {rid} returned {len(toks)} tokens")
    if not kw.get("prefix_cache"):
        check(res["warm_results"] == res["results"],
              f"serve {label}: the warm wave's tokens differ from the "
              "first wave's")
    check_serve_launches(res, counts, cfg, label, paged,
                         spec=bool(kw.get("speculate_k")))
    if cfg.moe is not None:
        check_moe_launches(res, counts, cfg, label)
    return res, counts


def families_serve(torch) -> dict:
    """The ``[families]`` phase: starcoder2-3b, nemotron-4-15b and
    codeqwen1.5-7b at full width and full depth, then deepseek-v3 at full
    width cut to 3 dense + 1 MoE layer (:func:`deepseek_cut`), each built
    in place from seeded bfloat16 weights and freed before the next,
    served paged on phase 4's traffic (16 requests, prompts of 64-512
    tokens, 64 new tokens each, batch 8, max_len 1024, 8 steps a segment,
    512 pages of 16), graphed, a first and a warm wave; deepseek once with
    the features off and once on the features cell's traffic with the
    prefix cache, chunks of 128 and speculation at k 4 (MLA's suffix
    prefill and verify on the card).  Launches exact (for deepseek no
    attention kernel and 3 grouped GEMMs a MoE layer and call).  Returns
    the graphed runs' launches of the three dense models, summed."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import Model
    t_phase = time.perf_counter()
    requests, max_new = 16, 64
    traffic = dict(prompt_len=(64, 513))
    totals: dict = {}
    for arch, (tag, geo) in FAMILIES.items():
        cfg = get_config(arch)
        gc.collect()                   # the last model's graphs and pools
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = Model(cfg).init(0, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        res, counts = _family_run(torch, cfg, params, held, f"{arch} paged",
                                  requests, max_new, **traffic)
        hq, hkv, d = geo
        _family_line(f"{arch} paged (Hq {hq}, Hkv {hkv}, D {d}, "
                     f"{cfg.n_layers} layers)", res, counts,
                     f"weights built in {built:.1f}s")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        del res, params
    cfg = deepseek_cut()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = Model(cfg).init(0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    res, counts = _family_run(torch, cfg, params, held,
                              "deepseek-v3 cut paged", requests, max_new,
                              **traffic)
    _family_line(f"{cfg.name} cut to 3 dense + 1 MoE layer, MLA, paged, "
                 "features off", res, counts, f"weights built in "
                 f"{built:.1f}s")
    totals["deepseek_group_gemm"] = counts["group_gemm"]
    res, counts = _family_run(torch, cfg, params, held,
                              "deepseek-v3 cut features", requests, max_new,
                              shared_prefix=256,
                              prompt_len=(64, 257), **FEATURES["b"])
    pre, sp, join = res["prefix"], res["spec"], res["first_join"]
    _family_line(f"{cfg.name} cut, paged, prefix cache + chunks of 128 + "
                 "speculation k 4 behind a 256-token shared prefix", res,
                 counts, f"first wave: prefix hits {pre['hits']}/"
                 f"{pre['admits']}, skipped prefill "
                 f"{pre['prefill_skipped']}, {join['chunk_joins']} chunk "
                 f"continuations, {sp['steps']} verify steps, acceptance "
                 f"{sp['acceptance_rate']:.3f}")
    check(pre["hits"] > 0 and pre["prefill_skipped"] > 0
          and join["chunk_joins"] > 0 and sp["steps"] > 0,
          "serve deepseek features: no prefix hit, chunk continuation or "
          "verify step")
    totals["deepseek_group_gemm"] += counts["group_gemm"]
    del res, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[families] phase took {time.perf_counter() - t_phase:.1f}s")
    return totals


def families_agreement(torch, archs=(*FAMILIES, MLA_ARCH)) -> None:
    """float32 at ``reduced()``, seeded weights: each configuration of
    ``archs``' greedy streams on the card (graphed) against the CPU's
    plain path, paged and dense, and deepseek-v3's also paged behind a
    32-token shared prefix with the prefix cache, chunks of 16 and
    speculation (k 3); equal, or a difference shown at a logit
    near-tie."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run
    from repro_torch.models.init import init_params
    kw = dict(requests=3, max_new=8, batch=2, max_len=128, page_size=16,
              sync_every=4, seed=1, prompt_len=(16, 40),
              dtype=torch.float32)
    feats = dict(prefix_cache=True, prefill_chunk=16, speculate_k=3,
                 shared_prefix=32)
    for arch in archs:
        cfg = get_config(arch).reduced()
        params = init_params(cfg, 1, device="cuda")
        cpu_params = _to(torch, params, "cpu")
        cases = [("paged", dict(paged=True)), ("dense", dict(paged=False))]
        if arch == MLA_ARCH:
            cases.append(("paged, prefix cache + chunks of 16 + "
                          "speculation k 3", dict(paged=True, **feats)))
        for label, extra in cases:
            on_card = run(cfg, device="cuda", params=params, **kw, **extra)
            on_cpu = run(cfg, device="cpu", params=cpu_params, **kw, **extra)
            prompts = on_cpu["prompts"]
            ties = sum(_near_tie(torch, cpu_params, cfg, prompts[rid],
                                 on_card["results"][rid], want,
                                 f"{arch} {label} request {rid}")
                       for rid, want in on_cpu["results"].items())
            n = len(on_cpu["results"])
            print(f"[agree] {arch} reduced float32 greedy streams, {label}, "
                  f"card (graphs) vs CPU plain path: {n - ties}/{n} equal, "
                  f"{ties} at near-ties")
            if "prefix_cache" in extra and not ties:
                for key in ("prefix", "spec"):
                    check(on_card[key] == on_cpu[key],
                          f"agreement {arch} {label}: {key} statistics "
                          "differ")


def ssm_kernels(torch) -> tuple[dict, dict]:
    """The attention kernels at zamba2's shared-block geometry
    (``ZAMBA_GEO``: 32 query over 32 KV heads, G 1, D 64), which no
    earlier phase launches: both paged kernels at every split and rows a
    CTA and the dense-stripe kernel over the whole stripe and under
    ``s_cap``, in both dtypes, against their plain versions; then their
    times over the 5 pools of the shared block's occurrences.  Returns
    (the largest bfloat16 errors, the timings)."""
    from repro_torch.configs import get_config
    worst = kernel_checks(torch, ZAMBA_GEO)
    worst["decode_attn"] = stripe_checks(torch, geos=(ZAMBA_GEO,))
    layers = attn_layers(get_config(SSM_ARCHS[1]))
    timings = kernel_timings(torch, ZAMBA_GEO, layers=layers)
    timings["decode_attn"] = stripe_timing(torch, ZAMBA_GEO, layers=layers)
    return worst, timings


def ssm_serve(torch) -> dict:
    """The ``[ssm]`` phase's serving: mamba2-370m (48 Mamba-2 blocks, no
    attention) and zamba2-1.2b (33 Mamba-2 blocks and a shared attention
    block at 5 occurrences) at full width and full depth, each built in
    place from seeded bfloat16 weights and freed before the next, served
    paged on phase 4's traffic (16 requests, prompts of 64-512 tokens, 64
    new tokens each, batch 8, max_len 1024, 8 steps a segment, 512 pages
    of 16), graphed, a first and a warm wave; zamba2 also on dense
    stripes.  Launches exact: none for mamba2, 5 a step and a join for
    zamba2's attention kernel.  Returns zamba2's launches, paged and
    dense summed."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import Model
    from repro_torch.models.transformer import cache_bytes
    requests, max_new = 16, 64
    traffic = dict(prompt_len=(64, 513))
    totals: dict = {}
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        gc.collect()                   # the last model's graphs and pools
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = Model(cfg).init(0, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        hold = cache_bytes(cfg, torch.bfloat16)
        layers = attn_layers(cfg)
        for layout, paged in (("paged", True), ("dense", False)):
            if not (paged or layers):
                continue               # mamba2: the paged run is enough
            res, counts = _family_run(torch, cfg, params, held,
                                      f"{arch} {layout}", requests, max_new,
                                      paged=paged, **traffic)
            steps = res["sync_every"] * res["segments"]
            kname = "paged_decode" if paged else "decode_attn"
            per = (f"{counts[kname] / steps:g} {kname} a decode step"
                   + (f", {counts['paged_prefill'] / res['joins']:g} "
                      "paged_prefill a join" if paged else "")
                   if layers else "no attention kernel")
            _family_line(
                f"{arch} {layout} ({cfg.n_layers} layers, {layers} of them "
                f"attention; KV {hold['kv_token'] / 1024:g} KiB a token, SSM "
                f"state {hold['ssm_slot'] / 2**20:.1f} MiB a slot)", res,
                counts, f"{per}; weights built in {built:.1f}s", tag="ssm")
            if layers:
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
            del res
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def ssm_padding_invariant(torch) -> None:
    """float32 at ``reduced()`` on the card, graphed, paged and dense: a
    10-token prompt's greedy stream joining alone (a join 16 wide) and
    beside a 30-token prompt (a join 32 wide, so the short row carries 22
    pad tokens) is the same, or differs at a logit near-tie."""
    from repro_torch.configs import get_config
    from repro_torch.models.init import init_params
    from repro_torch.models.model_zoo import Model
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import Batcher
    import numpy as np
    rng = np.random.default_rng(3)
    for arch in SSM_ARCHS:
        cfg = get_config(arch).reduced()
        params = init_params(cfg, 2, device="cuda")
        cpu_params = _to(torch, params, "cpu")
        short = rng.integers(0, cfg.vocab, size=10).tolist()
        long = rng.integers(0, cfg.vocab, size=30).tolist()
        for layout in ("paged", "dense"):
            streams = []
            for prompts in ({0: short}, {0: short, 1: long}):
                b = Batcher(Model(cfg), params, ServeConfig(
                    max_len=128, batch=2, dtype=torch.float32, sync_every=4,
                    paged=layout == "paged", page_size=16))
                for rid, p in prompts.items():
                    b.submit(rid, p)
                b.run(max_new=16)
                check(b.graph_count > 0, f"[ssm] {arch}: no decode graph")
                streams.append(b.results[0])
            tie = _near_tie(torch, cpu_params, cfg, short, streams[1],
                            streams[0], f"{arch} {layout} padding")
            print(f"[ssm] {arch} reduced float32 {layout}, graphs: a "
                  "10-token prompt alone (join 16 wide) and beside a "
                  "30-token one (join 32 wide): "
                  + ("differs at a near-tie" if tie else "equal streams"))


# ---------------------------------------------------------------------------
# phase 12, [train]
# ---------------------------------------------------------------------------

TRAIN_ARCHS = (ARCH, MOE_ARCH, MLA_ARCH, *SSM_ARCHS)
# the grouped GEMM's backward at a 4,096-token join's expert shapes:
# (label, arch, projection, the JSON keys of its bfloat16 times or None)
BWD_SHAPES = (("moonshot gate/up", MOE_ARCH, "gate/up", "bwd_"),
              ("moonshot down", MOE_ARCH, "down", "bwd_down_"),
              ("deepseek gate/up", MLA_ARCH, "gate/up", "ds_bwd_"),
              ("deepseek down", MLA_ARCH, "down", None))
BWD_GROUP = 64              # experts a check takes at once (deepseek: 4)


def expert_dims(arch: str, proj: str) -> tuple[int, int, int]:
    """(E, D, F) of full-width ``arch``'s gate/up or down projection."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    return (cfg.moe.n_experts,) + ((d, f) if proj == "gate/up" else (f, d))
PARAM_LR_SHARE = 2e-2       # see tests/test_torch_train_loop.py


def backward_inputs(torch, arch, d, f, dtype, lo, hi, seed):
    """Experts ``lo:hi`` of a 4,096-token join at full-width ``arch``:
    counts from the seeded routing the kernels phase draws, xe [E, C, D]
    zero past each count (as the dispatch leaves it), w [E, D, F] of std
    1/sqrt(D) and dy [E, C, F] float32 with NaN past each count."""
    cnt, c = routed_counts(torch, 4096, SEED + 1, arch)
    cnt = cnt[lo:hi].contiguous()
    e = cnt.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    live = torch.arange(c, device="cuda")[None, :, None] < cnt[:, None, None]
    xe = torch.randn(e, c, d, generator=gen, device="cuda").to(dtype) * live
    w = torch.empty(e, d, f, device="cuda", dtype=dtype)
    for i in range(e):
        w[i] = torch.randn(d, f, generator=gen, device="cuda") / math.sqrt(d)
    dy = torch.randn(e, c, f, generator=gen, device="cuda")
    dy = torch.where(live, dy, torch.full_like(dy, float("nan")))
    return cnt, live, xe, w, dy


def group_gemm_backward_checks(torch) -> dict:
    """The autograd backward of ``group_gemm`` on the card (``dxe`` through
    the kernel, ``dw`` through ``torch.bmm``) against autograd through its
    plain version, at full-width moonshot's (E 64, C 480) and deepseek's
    (E 256, C 160, 64 experts at a time) expert shapes, gate/up and down,
    in both dtypes: ``dy`` holds NaN past each count, and so does the
    kernel's ``xe`` (the plain version's is zero there, as the dispatch
    leaves it: the forward reads neither).  Within ``TOL`` of the plain
    version's largest entry; ``dxe``'s rows past the counts exactly 0;
    everything finite; one kernel launch forward and one backward.
    Returns the largest relative errors (bfloat16) by label."""
    from repro_torch.kernels import moe_group_gemm as mg
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for label, arch, proj, _ in BWD_SHAPES:
            n_exp, d, f = expert_dims(arch, proj)
            errs, zeros, finite, rows = [0.0, 0.0], True, True, 0
            for lo in range(0, n_exp, BWD_GROUP):
                cnt, live, xe, w, dy = backward_inputs(
                    torch, arch, d, f, dtype, lo, lo + BWD_GROUP, SEED + lo)
                rows += int(cnt.sum())
                x_nan = torch.where(live, xe, torch.full_like(
                    xe, float("nan"))).requires_grad_()
                wk = w.clone().requires_grad_()
                mg.reset_launch_counts()
                got = torch.autograd.grad(mg.group_gemm(x_nan, wk, cnt),
                                          (x_nan, wk), dy)
                torch.cuda.synchronize()
                check(mg.launch_counts["group_gemm"] == 2,
                      f"group_gemm backward {label}: "
                      f"{mg.launch_counts['group_gemm']} launches, not 2")
                xr, wr = xe.requires_grad_(), w.requires_grad_()
                want = torch.autograd.grad(mg.group_gemm_ref(xr, wr, cnt),
                                           (xr, wr), dy)
                for i in range(2):
                    scale = float(want[i].abs().max().float())
                    errs[i] = max(errs[i], float((got[i].float() - want[i]
                                                  .float()).abs().max())
                                  / max(scale, 1e-30))
                    finite = finite and bool(torch.isfinite(got[i]).all())
                zeros = zeros and bool((got[0][~live.expand_as(
                    got[0])] == 0).all())
                del x_nan, wk, got, want, xr, wr, xe, w, dy
                torch.cuda.empty_cache()
            print(f"[train] group_gemm backward {name} {label} (D={d} "
                  f"F={f}, {rows} live rows of a 4,096-token join, dy and "
                  f"the kernel's xe NaN past the counts) vs autograd "
                  f"through the plain version: dxe {errs[0]:.3e}, dw "
                  f"{errs[1]:.3e} of the largest entry (tolerance "
                  f"{TOL[name]}); dxe rows past the counts exactly 0: "
                  f"{zeros}; finite: {finite}")
            check(max(errs) <= TOL[name] and zeros and finite,
                  f"group_gemm backward disagrees ({name}, {label})")
            if name == "bfloat16":
                worst[label] = max(errs)
    return worst


def group_gemm_backward_timing(torch) -> dict:
    """The bfloat16 backward (:func:`group_gemm_backward`: dy's mask, the
    transposed weights, the kernel for dxe, ``torch.bmm`` for dw) at
    moonshot's gate/up (``bwd_*`` keys) and down (``bwd_down_*``) and
    deepseek's gate/up (``ds_bwd_*``, all 256 experts) at a 4,096-token
    join; beside it autograd through the plain version (``plain_ms``) and
    two ``torch.bmm`` calls for the same products over the padded slabs
    (``library_ms``), and two of its parts alone (``transpose_ms``, the
    copy of w transposed, and ``kernel_ms``, the kernel for dxe).  The
    bound counts the live experts' weights, the
    live rows of xe and dy in, dxe and every expert's dw out, and 4 x
    live rows x D x F operations."""
    from repro_torch.kernels import moe_group_gemm as mg
    row, item = {}, 2
    for label, arch, proj, key in BWD_SHAPES:
        if key is None:
            continue
        n_exp, d, f = expert_dims(arch, proj)
        cnt, live, xe, w, dy = backward_inputs(
            torch, arch, d, f, torch.bfloat16, 0, n_exp, SEED)
        e, c = xe.shape[:2]
        n_rows, n_live = int(cnt.sum()), int((cnt > 0).sum())
        nbytes = (n_live * d * f * item + n_rows * d * item + n_rows * f * 4
                  + e * c * d * item + e * d * f * item + e * 4)
        flops = 4.0 * n_rows * d * f
        t_bound, by = bound(nbytes, flops, "bfloat16")
        dy16 = torch.where(live, dy, torch.zeros_like(dy)).to(torch.bfloat16)
        wt = w.transpose(1, 2)
        part = {"ms": time_ms(lambda i: mg.group_gemm_backward(
                    xe, w, cnt, dy), 5),
                "library_ms": time_ms(lambda i: (
                    torch.bmm(dy16, wt), torch.bmm(xe.transpose(1, 2),
                                                   dy16)), 5),
                # its parts: the transposed copy of w, the kernel for dxe
                "transpose_ms": time_ms(lambda i: wt.contiguous(), 5)}
        wt_c = wt.contiguous()
        part["kernel_ms"] = time_ms(lambda i: mg.kernel.group_gemm_cuda(
            dy16, wt_c, cnt), 5)
        del dy16, wt, wt_c
        torch.cuda.empty_cache()
        xr, wr = xe.requires_grad_(), w.requires_grad_()
        out = mg.group_gemm_ref(xr, wr, cnt)
        part["plain_ms"] = time_ms(lambda i: torch.autograd.grad(
            out, (xr, wr), dy, retain_graph=True), 2, reps=2)
        del out, xr, wr
        part.update(bound_ms=t_bound, bound_by=by, flops=flops, bytes=nbytes)
        row.update({key + k: v for k, v in part.items()})
        print(f"[timing] group_gemm backward {label} (E={e} C={c} D={d} "
              f"F={f} bf16, {n_rows} live rows in {n_live} live experts): "
              f"ms {part['ms']:.4f} (of it the transposed copy of w "
              f"{part['transpose_ms']:.4f}, the kernel for dxe "
              f"{part['kernel_ms']:.4f}), plain_ms (autograd through the "
              f"plain version) {part['plain_ms']:.4f}, library_ms (2 "
              f"torch.bmm, padded) {part['library_ms']:.4f}, bound_ms "
              f"{t_bound:.4f} "
              f"({by}), {flops / part['ms'] / 1e9:.1f} TFLOP/s, "
              f"{t_bound / part['ms']:.1%} of its bound; {SMI}")
        del xe, w, dy
        torch.cuda.empty_cache()
    return row


def train_qwen(torch) -> dict:
    """(b) Full-width, full-depth qwen2-0.5b through
    ``repro_torch.launch.train.run``: seeded float32 params and moments,
    bfloat16 activations, remat, the port's ``DataPipeline`` at L 4,096,
    batch 8 in 2 microbatches of 4, lr 3e-4 (warmup 2, cosine over 12
    steps), an async checkpoint every 4 steps into a temporary directory
    and an injected failure at step 9 (restored from step 8).  Gates:
    every loss and grad norm finite; 12 steps done (13 run: step 8 twice);
    step 8's loss after the restore equal to its first; the last
    checkpoint restores bit for bit into the final state, its data step
    12; the mean loss of the last 3 steps below step 0's.  Prints the
    median step ms (from step 2), tokens/s, model TFLOP/s (6 N tokens plus
    the attention's 12 L Hq hd a token and layer) and its share of the
    bfloat16 peak, peak device memory and the checkpoint's bytes and
    stall."""
    from repro_torch import tree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run
    cfg = get_config(ARCH)
    steps, batch, seq = 12, 8, 4096
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = run(ARCH, steps=steps, batch=batch, seq=seq, reduced=False,
                  ckpt_dir=tmp, ckpt_every=4, accum=2, lr=3e-4,
                  fail_at=(9,), seed=SEED, log_every=1, device="cuda")
        took = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        state = res["state"]
        ck = Checkpointer(tmp)
        saved, manifest = ck.restore(state)
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree.paths(saved), tree.paths(state)))
        ckpt_bytes = sum(p.stat().st_size for p in
                         (pathlib.Path(tmp) / "step_0000000012").iterdir())
        kept = ck.all_steps()
        del saved
    losses, norms = res["losses"], res["grad_norms"]
    n_params = sum(t.numel() for t in tree.leaves(state["params"]))
    check(all(math.isfinite(v) for v in losses + norms),
          "train qwen: a loss or grad norm is not finite")
    check(len(losses) == steps + 1 and int(state["opt"]["step"]) == steps,
          f"train qwen: {len(losses)} steps run, optimizer at "
          f"{int(state['opt']['step'])}")
    check(kept == [4, 8, 12] and same and manifest["step"] == steps
          and manifest["extra"]["data"]["step"] == steps,
          f"train qwen: checkpoints {kept}, last restored bit for bit "
          f"{same}, manifest {manifest['step']}, data step "
          f"{manifest['extra']['data']}")
    # the loss of step 8, before the failure and after the restore
    again = losses[9] == losses[8]
    check(abs(losses[9] - losses[8]) <= 1e-5 * abs(losses[8]),
          f"train qwen: step 8's loss {losses[8]} before the failure, "
          f"{losses[9]} after the restore")
    tail = statistics.mean(losses[-3:])
    check(tail < losses[0], f"train qwen: mean loss of the last 3 steps "
          f"{tail:.4f} not below step 0's {losses[0]:.4f}")
    step_ms = statistics.median(res["step_s"][2:]) * 1e3
    tokens = batch * seq
    attn = 12 * seq * cfg.n_heads * cfg.resolved_head_dim * cfg.n_layers
    model_flops = (6 * n_params + attn) * tokens
    tflops = model_flops / step_ms / 1e9
    stall_ms = [s * 1e3 for s in res["ckpt_stall_s"]]
    print(f"[train] qwen2-0.5b full width and depth ({n_params} params, "
          f"float32 params and moments, bf16 activations, remat), L {seq}, "
          f"batch {batch} in 2 microbatches, 12 steps + 1 rerun after the "
          f"failure at step 9, in {took:.1f}s: losses "
          + " ".join(f"{v:.4f}" for v in losses)
          + "; grad norms " + " ".join(f"{v:.3f}" for v in norms))
    dense_tf, attn_tf = 6 * n_params * tokens / 1e12, attn * tokens / 1e12
    print(f"[train] qwen2-0.5b step: median {step_ms:.1f} ms (steps 2 on), "
          f"{tokens / step_ms * 1e3:.0f} tokens/s, model "
          f"{model_flops / 1e12:.1f} TFLOP a step (6 N T {dense_tf:.1f} + "
          f"attention {attn_tf:.1f}) = "
          f"{tflops:.1f} TFLOP/s, {tflops / 989:.1%} of the 989 TFLOP/s "
          f"bf16 peak; peak device memory {peak:.2f} GiB; checkpoint "
          f"{ckpt_bytes / 2**30:.2f} GiB, stall "
          f"{' '.join(f'{v:.0f}' for v in stall_ms)} ms "
          f"(the host copy); step 8's loss after the restore equal bit for "
          f"bit: {again}; {SMI}")
    out = {"step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "model_tflop_per_s": tflops, "peak_gib": peak,
           "ckpt_gib": ckpt_bytes / 2**30,
           "ckpt_stall_ms": max(stall_ms)}
    del res, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_moe_cut(torch) -> int:
    """(c) moonshot-v1-16b-a3b at full width cut to 1 dense + 1 MoE layer
    (all 64 experts and the vocab kept): seeded float32 params, bf16
    activations, remat, batch 4 x L 1,024 from the port's
    ``DataPipeline``.  One microbatch's gradients: every leaf finite and
    ``wi``, ``wg`` and ``wo`` each a non-zero norm.  Then 4 train steps:
    finite losses, and ``group_gemm`` launched exactly 3 GEMMs x
    (forward, remat's recompute, backward) x the MoE layer x 4 steps.
    Returns those launches."""
    from repro_torch import tree
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models.model_zoo import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import (TrainConfig, loss_and_grads,
                                              make_train_state,
                                              make_train_step)
    cfg = moe_cut(1)
    model = Model(cfg)
    steps = 4
    tcfg = TrainConfig(opt=opt.OptConfig(lr=3e-4, warmup_steps=2,
                                         total_steps=steps))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = make_train_state(model, SEED, tcfg, device="cuda")
    n_params = sum(t.numel() for t in tree.leaves(state["params"]))
    data = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=1024,
                                   global_batch=4, seed=SEED))
    batch = lambda s: {"tokens": torch.from_numpy(  # noqa: E731
        data.batch_at(s)["tokens"]).cuda()}
    _, grads = loss_and_grads(model, state["params"], batch(0), tcfg)
    norms = {k: float(g.norm()) for k, g in zip(
        (k for k, _ in tree.paths(state["params"])), grads)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    del grads
    experts = {n: norms[f"segments/1/moe/{n}"] for n in ("wi", "wg", "wo")}
    check(finite and all(v > 0 for v in experts.values()),
          f"train moe: gradients finite {finite}, expert norms {experts}")
    reset_counts()
    step = make_train_step(model, tcfg)
    losses = []
    for s in range(steps):
        state, m = step(state, batch(s))
        losses.append(float(m["loss"]))
    counts = read_counts()
    n_moe = 1
    want = 3 * 3 * n_moe * steps
    check(all(math.isfinite(v) for v in losses),
          f"train moe: losses {losses}")
    check(counts["group_gemm"] == want,
          f"train moe: group_gemm launched {counts['group_gemm']} times, "
          f"not {want}")
    print(f"[train] moonshot cut to 1 dense + 1 MoE layer at full width "
          f"({n_params} params, 64 experts), batch 4 x L 1,024, bf16, "
          f"remat: every gradient finite, expert gradient norms "
          + ", ".join(f"{k} {v:.4g}" for k, v in experts.items())
          + f"; 4 steps, losses " + " ".join(f"{v:.4f}" for v in losses)
          + f"; group_gemm launches {counts['group_gemm']} = 3 GEMMs x "
          f"(forward, recompute, backward) x 1 MoE layer x 4 steps; "
          f"{time.perf_counter() - t0:.1f}s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {SMI}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return counts["group_gemm"]


def train_agreement(torch) -> None:
    """(d) float32 at ``reduced()``: 3 train steps (lr 1e-3, warmup 2,
    remat) of each of ``TRAIN_ARCHS`` from one seeded state, on the card
    (the grouped GEMM's kernel forward and backward) and on the CPU (the
    plain path), on the port's ``DataPipeline`` batches (4 x 64).  Each
    step's loss within 1e-4 relative; the final params within max(1e-4 x
    the leaf's largest entry, ``PARAM_LR_SHARE`` x the summed lr), the
    tolerance the CPU tests hold the port to JAX with; ``group_gemm``
    launched 9 times a MoE layer and step."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models.init import init_params
    from repro_torch.models.model_zoo import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import (TrainConfig, make_train_state,
                                              make_train_step)
    steps = 3
    tcfg = TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=steps),
                       dtype=torch.float32)
    lr_sum = sum(float(opt.schedule(s, tcfg.opt)) for s in range(steps))
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        model = Model(cfg)
        params = init_params(cfg, 1, device="cuda")
        cpu = make_train_state(model, 0, tcfg, device="cpu",
                               params=_to(torch, params, "cpu"))
        card = make_train_state(model, 0, tcfg, params=params)
        step = make_train_step(model, tcfg)
        data = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=64,
                                       global_batch=4, seed=SEED))
        rel = []
        reset_counts()
        for s in range(steps):
            tokens = torch.from_numpy(data.batch_at(s)["tokens"])
            card, mc = step(card, {"tokens": tokens.cuda()})
            cpu, mp = step(cpu, {"tokens": tokens})
            rel.append(abs(float(mc["loss"]) - float(mp["loss"]))
                       / abs(float(mp["loss"])))
        launches = read_counts()["group_gemm"]
        n_moe = sum(g.count for g in cfg.resolved_segments()
                    if g.kind.value == "moe")
        worst, worst_key = 0.0, ""
        for (key, a), (_, b) in zip(tree.paths(card["params"]),
                                    tree.paths(cpu["params"])):
            tol = max(1e-4 * float(b.abs().max()), PARAM_LR_SHARE * lr_sum)
            err = float((a.cpu() - b).abs().max()) / tol
            if err > worst:
                worst, worst_key = err, key
        print(f"[train] {arch} reduced float32, 3 steps, card vs CPU plain "
              f"path: loss relative differences "
              + " ".join(f"{v:.2e}" for v in rel)
              + f"; params at most {worst:.3f} of their tolerance "
              f"({worst_key}); group_gemm launches {launches}")
        check(max(rel) <= 1e-4, f"train agreement {arch}: losses differ")
        check(worst <= 1.0, f"train agreement {arch}: {worst_key} differs")
        check(launches == 9 * n_moe * steps,
              f"train agreement {arch}: group_gemm launched {launches} "
              f"times, not {9 * n_moe * steps}")


def train_phase(torch) -> dict:
    """Phase 12, ``[train]``: (a) the grouped GEMM's backward checked and
    timed, (b) full-width qwen2-0.5b trained through a failure, (c) the
    full-width moonshot cut trained through the kernel, (d) card = CPU at
    ``reduced()``.  Returns the backward's times and errors (the
    group_gemm row's ``bwd_*`` keys) and the launches of (c)."""
    t0 = time.perf_counter()
    worst = group_gemm_backward_checks(torch)
    row = group_gemm_backward_timing(torch)
    row["bwd_max_rel_err"] = worst["moonshot gate/up"]
    row["ds_bwd_max_rel_err"] = worst["deepseek gate/up"]
    qwen = train_qwen(torch)
    row.update({f"train_{k}": v for k, v in qwen.items()})
    row["train_launches"] = train_moe_cut(torch)
    train_agreement(torch)
    print(f"[train] phase took {time.perf_counter() - t0:.1f}s")
    return row


# ---------------------------------------------------------------------------
# phase 13, [encdec]
# ---------------------------------------------------------------------------

WHISPER, VISION = "whisper-tiny", "internvl2-26b"
WHISPER_GEO = (6, 6, 64)          # its Hq, Hkv, head_dim (G 1): "w64_"
# whisper's leaves a text-only loss never reaches: the per-layer cross k
# and v (the cross layers read cross_k and cross_v) always, the rest of
# the cross branch and the encoder whenever no frames come
UNREAD_TEXT_ONLY = ("segments/0/cross/", "segments/0/norm_x/", "encoder/",
                    "enc_norm/", "cross_k/", "cross_v/")


def encdec_kernels(torch) -> tuple[dict, dict]:
    """(a) The attention kernels at whisper-tiny's geometry
    (``WHISPER_GEO``: 6 query over 6 KV heads, G 1, D 64, so 48 (slot, KV
    head) rows at the serve batch of 8), which no earlier phase launches:
    both paged kernels at every split and rows a CTA and the dense-stripe
    kernel over the whole stripe and under ``s_cap``, in both dtypes,
    against their plain versions; then their times over whisper's 4
    decoder layers.  Returns (the largest bfloat16 errors, the
    timings)."""
    from repro_torch.configs import get_config
    worst = kernel_checks(torch, WHISPER_GEO)
    worst["decode_attn"] = stripe_checks(torch, geos=(WHISPER_GEO,))
    layers = attn_layers(get_config(WHISPER))
    timings = kernel_timings(torch, WHISPER_GEO, layers=layers)
    timings["decode_attn"] = stripe_timing(torch, WHISPER_GEO, layers=layers)
    return worst, timings


def side_inputs(torch, cfg, b: int, dtype, seed: int,
                device="cuda") -> dict:
    """Seeded stub encoder frames [b, encoder_seq, d] (whisper) or vision
    embeddings [b, vision_tokens, d] (internvl2), drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.enc_dec:
        return {"encoder_frames": torch.randn(
            b, cfg.encoder_seq, cfg.d_model, generator=gen,
            device=device).to(dtype)}
    return {"vision_embeds": torch.randn(
        b, cfg.vision_tokens, cfg.d_model, generator=gen,
        device=device).to(dtype)}


def prefill_decode(torch, model, params, batch: dict, lens, steps: int, *,
                   paged: bool, dtype, extra=None, forced=None,
                   keep_logits: bool = False) -> dict:
    """``Model.prefill`` into dense stripes sized for the prompt and
    ``steps`` more tokens, or ``Model.prefill_paged`` through a permuted
    table of pages of ``PS`` (each row its own), with each row's logits
    at ``lens - 1``; then ``steps`` greedy one-token ``decode_step``s at
    per-slot depths with ``extra`` (whisper's ``cross_kv``), the tokens
    fed ``forced`` ([B, steps + 1] on the host) where given.  Returns the
    greedy tokens [B, steps + 1] and the top-2 logit gap of each
    (host), the seconds, and with ``keep_logits`` each call's logits
    [steps + 1, B, V] (host)."""
    b, width = batch["tokens"].shape
    dev = batch["tokens"].device
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = lens - 1
    kw = {}
    if paged:
        per = -(-(width + steps) // PS)
        gen = torch.Generator().manual_seed(b * per)
        tbl = torch.randperm(b * per, generator=gen).to(
            torch.int32).reshape(b, per).to(dev)
        caches = model.init_paged_caches(b, b * per, PS, dtype, device=dev)
        logits, caches = model.prefill_paged(params, batch, caches, tbl,
                                             dtype=dtype, last_pos=last)
        kw["pages"] = tbl
    else:
        logits, caches = model.prefill(params, batch, width + steps,
                                       dtype=dtype, last_pos=last)
    depth = lens.to(torch.int32)
    toks, gaps, kept = [], [], []
    for i in range(steps + 1):
        top = logits[:, -1].topk(2, dim=-1)
        toks.append(top.indices[:, 0])
        gaps.append(top.values[:, 0] - top.values[:, 1])
        if keep_logits:
            kept.append(logits[:, -1].cpu())
        if i == steps:
            break
        feed = toks[-1] if forced is None else forced[:, i].to(dev)
        logits, caches = model.decode_step(params, feed[:, None], caches,
                                           depth, dtype=dtype, extra=extra,
                                           **kw)
        depth = depth + 1
    out = {"tokens": torch.stack(toks, 1).cpu(),
           "gaps": torch.stack(gaps, 1).cpu()}
    out["seconds"] = time.perf_counter() - t0
    if keep_logits:
        out["logits"] = torch.stack(kept)
    return out


def ragged_prompts(torch, vocab: int, b: int, lo: int, hi: int, seed: int,
                   device="cuda"):
    """b seeded prompts of lo..hi - 1 tokens, padded into one [b, width]
    batch; returns (tokens, lengths [b] int64)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, size=b)
    toks = rng.integers(0, vocab, size=(b, int(lens.max())))
    return (torch.from_numpy(toks).to(device),
            torch.from_numpy(lens).to(device))


def _streams_agree(label: str, got: dict, want: dict) -> int:
    """Equal greedy streams, or each row's first difference at a near-tie
    of ``want``'s logits there; returns the rows that differ."""
    rows = 0
    for r in range(want["tokens"].shape[0]):
        a, w = got["tokens"][r], want["tokens"][r]
        diff = (a != w).nonzero()
        if len(diff):
            i = int(diff[0])
            gap = float(want["gaps"][r, i])
            print(f"[encdec] {label} row {r} differs at token {i}: top-2 "
                  f"logit gap {gap:.2e}")
            check(gap < NEAR_TIE, f"[encdec] {label}: row {r} differs "
                  "without a near-tie")
            rows += 1
    return rows


def whisper_full_width(torch) -> dict:
    """(b) whisper-tiny at full width and depth (4 + 4 layers, d 384, 6
    heads, vocab 51,865), seeded bfloat16 weights built in place: 8 rows
    of 1,500 seeded stub frames, ``encode``; prompts of 4-64 tokens; on
    dense stripes ``Model.prefill`` with the frames (encoded inside the
    call) and on pages ``Model.prefill_paged`` with the encoder's
    ``cross_kv``, each then 64 greedy ``decode_step``s with
    ``extra={"cross_kv"}``: launches exact (the dense decode kernel 4 a
    step; the paged prefill kernel 4 a call and the decode kernel 4 a
    step), streams in vocabulary.  In float32 (the same weights), each
    layout's kernel route against ``DecodeAttnPolicy`` mode ``plain``:
    equal streams, or a difference at a near-tie.  Then text-only serving
    through both batchers on phase 4's traffic, graphed.  Returns the
    launches, the dense and paged bf16 runs' summed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import decode_attn_policy
    from repro_torch.models.model_zoo import Model
    from repro_torch.models.transformer import encode
    cfg = get_config(WHISPER)
    model = Model(cfg)
    steps, layers = 64, attn_layers(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    params = model.init(0, device="cuda", dtype=torch.bfloat16)
    frames = side_inputs(torch, cfg, 8, torch.bfloat16, SEED)
    toks, lens = ragged_prompts(torch, cfg.vocab, 8, 4, 65, SEED)
    with torch.no_grad():
        enc_ms = time_ms(lambda i: encode(params, frames["encoder_frames"],
                                          cfg), 3, reps=3)
        kv = encode(params, frames["encoder_frames"], cfg)
        totals, runs = {}, {}
        for layout, paged in (("dense", False), ("paged", True)):
            batch = ({"tokens": toks, **frames} if not paged
                     else {"tokens": toks, "cross_kv": kv})
            reset_counts()
            runs[layout] = res = prefill_decode(
                torch, model, params, batch, lens, steps, paged=paged,
                dtype=torch.bfloat16, extra={"cross_kv": kv})
            counts = read_counts()
            want = ({"paged_prefill": layers, "paged_decode": layers * steps,
                     "decode_attn": 0} if paged else
                    {"paged_prefill": 0, "paged_decode": 0,
                     "decode_attn": layers * steps})
            print(f"[encdec] {WHISPER} bf16 {layout}: prefill of 8 prompts "
                  f"of {int(lens.min())}-{int(lens.max())} tokens over "
                  f"{cfg.encoder_seq} frames (encode {enc_ms:.3f} ms), then "
                  f"{steps} greedy steps with cross_kv, in "
                  f"{res['seconds']:.2f}s; launches "
                  f"{ {k: counts[k] for k in want} }; {SMI}")
            check(all(counts[k] == v for k, v in want.items()),
                  f"[encdec] {WHISPER} {layout}: launches {counts}, not "
                  f"{want}")
            check(bool(((res["tokens"] >= 0)
                        & (res["tokens"] < cfg.vocab)).all()),
                  f"[encdec] {WHISPER} {layout}: a token out of vocab")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
        same = int((runs["dense"]["tokens"] == runs["paged"]["tokens"]
                    ).all(1).sum())
        print(f"[encdec] {WHISPER} bf16 greedy streams, dense (frames in "
              f"the prefill) vs paged (cross_kv in the prefill): {same}/8 "
              "rows equal")
        params32 = _cast(torch, params, torch.float32)
        f32 = {k: v.float() for k, v in frames.items()}
        kv32 = encode(params32, f32["encoder_frames"], cfg)
        for layout, paged in (("dense", False), ("paged", True)):
            got = {}
            for mode in ("kernel", "plain"):
                with decode_attn_policy(mode=mode):
                    got[mode] = prefill_decode(
                        torch, model, params32,
                        {"tokens": toks, "cross_kv": kv32}, lens, steps,
                        paged=paged, dtype=torch.float32,
                        extra={"cross_kv": kv32})
            ties = _streams_agree(f"{WHISPER} float32 {layout} kernel vs "
                                  "plain", got["kernel"], got["plain"])
            print(f"[encdec] {WHISPER} float32 {layout}, {steps} steps with "
                  f"cross_kv: kernel route vs plain route (DecodeAttnPolicy "
                  f"mode plain): {8 - ties}/8 streams equal, {ties} at "
                  "near-ties")
        del params32, kv32
    for layout, paged in (("paged", True), ("dense", False)):
        res, counts = _family_run(torch, cfg, params, held,
                                  f"{WHISPER} {layout}", 16, 64,
                                  paged=paged, prompt_len=(64, 513))
        _family_line(f"{WHISPER} {layout}, text only (Hq 6, Hkv 6, D 64, "
                     f"{cfg.n_layers} decoder layers)", res, counts,
                     "no frames: the batchers carry none, as JAX's",
                     tag="encdec")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        del res
    del params, kv
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def vision_full_width(torch) -> dict:
    """(c) internvl2-26b at full width and full depth (48 layers, d 6,144,
    48 query over 8 KV heads, vocab 92,553: about 42 GB of seeded
    bfloat16 weights with the float32 embedding and read-out, built in
    place): 8 rows of 256 seeded vision embeddings and a text prompt of
    8-64 tokens past them, ``Model.prefill_paged`` then 64 greedy
    ``decode_step``s on pages (launches exact); text-only serving through
    the paged batcher on phase 4's traffic, graphed; and the decode step
    profiled (``profile_serve.profile_decode``, which builds the same
    seeded weights once these are freed).  Peaks are counted above what
    earlier phases still hold.
    Returns the launches of the prefill-and-decode run and of the serve
    run, summed, and the profile's summary."""
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_serve import profile_decode
    from repro_torch.models.model_zoo import Model
    cfg = get_config(VISION)
    model = Model(cfg)
    steps, layers = 64, attn_layers(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    weights = (torch.cuda.memory_allocated() - held) / 2**30
    text, lens = ragged_prompts(torch, cfg.vocab, 8, 8, 65, SEED)
    pad = torch.zeros(8, cfg.vision_tokens, dtype=text.dtype, device="cuda")
    toks, lens = torch.cat([pad, text], 1), lens + cfg.vision_tokens
    vision = side_inputs(torch, cfg, 8, torch.bfloat16, SEED)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        res = prefill_decode(torch, model, params,
                             {"tokens": toks, **vision}, lens, steps,
                             paged=True, dtype=torch.bfloat16)
    counts = read_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    want = {"paged_prefill": layers, "paged_decode": layers * steps,
            "decode_attn": 0}
    print(f"[encdec] {VISION} bf16 paged, full width and depth ({weights:.2f}"
          f" GiB of weights built in {built:.1f}s): 8 rows of "
          f"{cfg.vision_tokens} vision embeddings + {int(lens.min()) - 256}-"
          f"{int(lens.max()) - 256} text tokens, prefill_paged and {steps} "
          f"greedy steps in {res['seconds']:.2f}s; peak device memory "
          f"{peak:.2f} GiB above the {held / 2**30:.2f} GiB held before; "
          f"launches { {k: counts[k] for k in want} }; {SMI}")
    check(all(counts[k] == v for k, v in want.items()),
          f"[encdec] {VISION}: launches {counts}, not {want}")
    check(bool(((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all()),
          f"[encdec] {VISION}: a token out of vocab")
    totals = dict(counts)
    serve, counts = _family_run(torch, cfg, params, held,
                                f"{VISION} paged", 16, 64,
                                prompt_len=(64, 513))
    _family_line(f"{VISION} paged, text only (Hq 48, Hkv 8, D 128, "
                 f"{cfg.n_layers} layers)", serve, counts,
                 f"weights built in {built:.1f}s", tag="encdec")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    del serve, params
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_decode(cfg, paged=True)
    print(f"[encdec] {VISION} paged decode step, graphs: wall "
          f"{prof['wall_ms_per_step']:.2f} ms, device busy "
          f"{prof['device_busy_ms_per_step']:.2f} ms, idle "
          f"{prof['idle_share']:.1%}, {prof['kernels_per_step']:.0f} kernels "
          f"a step; {SMI}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": totals, "profile": prof}


def encdec_agreement(torch) -> None:
    """(d) float32 at ``reduced()``, seeded weights, card against the CPU's
    plain path: for both models, a ragged prefill with the frames or the
    vision prefix (dense and paged) then 3 decode steps (whisper's with
    ``cross_kv``), the CPU's greedy tokens fed to both: logits within
    1e-4; ``Model.loss`` with the frames or the vision prefix within 1e-5
    relative and every gradient leaf within 1e-4 of its largest entry
    (whisper's per-layer cross k and v exactly zero on both)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models.init import init_params
    from repro_torch.models.model_zoo import Model
    from repro_torch.models.transformer import encode
    from repro_torch.train.train_loop import TrainConfig, loss_and_grads
    tcfg = TrainConfig(dtype=torch.float32, remat=False)
    for arch in (WHISPER, VISION):
        cfg = get_config(arch).reduced()
        model = Model(cfg)
        params = init_params(cfg, 1, device="cuda")
        cpu_params = _to(torch, params, "cpu")
        side = side_inputs(torch, cfg, 3, torch.float32, 2, device="cpu")
        toks, lens = ragged_prompts(torch, cfg.vocab, 3, 12, 17, 2,
                                    device="cpu")
        worst = 0.0
        for layout, paged in (("dense", False), ("paged", True)):
            runs = {}
            for dev, p in (("cpu", cpu_params), ("cuda", params)):
                batch = {"tokens": toks.to(dev),
                         **{k: v.to(dev) for k, v in side.items()}}
                extra = ({"cross_kv": encode(p, batch["encoder_frames"],
                                             cfg)} if cfg.enc_dec else None)
                runs[dev] = prefill_decode(
                    torch, model, p, batch, lens.to(dev), 3, paged=paged,
                    dtype=torch.float32, extra=extra, keep_logits=True,
                    forced=runs["cpu"]["tokens"] if dev == "cuda" else None)
            err = float((runs["cuda"]["logits"] - runs["cpu"]["logits"]
                         ).abs().max())
            worst = max(worst, err)
            check(err <= TOL["float32"], f"[encdec] {arch} reduced {layout}: "
                  f"card logits differ from the CPU's by {err:.2e}")
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 24),
                                         generator=torch.Generator()
                                         .manual_seed(3)),
                 **side_inputs(torch, cfg, 2, torch.float32, 4,
                               device="cpu")}
        loss, grads = {}, {}
        for dev, p in (("cpu", cpu_params), ("cuda", params)):
            loss[dev], grads[dev] = loss_and_grads(
                model, p, {k: v.to(dev) for k, v in batch.items()}, tcfg)
        rel = abs(float(loss["cuda"]) - float(loss["cpu"])) / abs(
            float(loss["cpu"]))
        gworst, zero = 0.0, []
        for i, (key, _) in enumerate(tree.paths(params)):
            g, w = grads["cuda"][i].cpu(), grads["cpu"][i]
            scale = float(w.abs().max())
            if scale == 0:
                check(not g.any(), f"[encdec] {arch}: {key}'s gradient is "
                      "zero on the CPU, not on the card")
                zero.append(key)
                continue
            gworst = max(gworst, float((g - w).abs().max()) / scale)
        print(f"[encdec] {arch} reduced float32, card vs CPU plain path: "
              f"prefill and 3 decode steps' logits (dense, paged) max_abs_err "
              f"{worst:.2e}; loss with the "
              f"{'frames' if cfg.enc_dec else 'vision prefix'} relative "
              f"difference {rel:.2e}, gradients at most {gworst:.2e} of each "
              f"leaf's largest entry; zero-gradient leaves {zero}")
        check(rel <= 1e-5 and gworst <= 1e-4,
              f"[encdec] {arch}: loss or gradients differ card vs CPU")
        if cfg.enc_dec:
            check({f"segments/0/cross/{n}/w" for n in "kv"} <= set(zero),
                  f"[encdec] {arch}: the per-layer cross k or v has a "
                  "gradient")


def train_whisper(torch) -> dict:
    """(e) whisper-tiny at full width and depth trained 4 steps through
    ``repro_torch.launch.train.run`` on the card (text only, as JAX's
    ``launch/train.py``: no frames, so the decoder skips cross-attention),
    batch 8 x L 448 (whisper's decoder context), remat: finite losses; the
    per-layer ``cross`` k and v (which no call reads), and the rest of the
    cross branch and the encoder (which a text-only batch never runs), get
    zero gradients (their second moments stay exactly 0) and move by
    AdamW's weight decay only (matrices by the factor prod(1 - lr_t wd),
    vectors not at all).  The peak is counted above what earlier phases
    still hold.  Returns the step's median ms."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run
    from repro_torch.models.model_zoo import Model
    from repro_torch.train import optimizer as opt
    steps = 4
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = run(WHISPER, steps=steps, batch=8, seq=448, reduced=False, lr=3e-4,
              seed=SEED, log_every=1, device="cuda")
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    state = res["state"]
    init = Model(get_config(WHISPER)).init(SEED, device="cuda")
    ocfg = opt.OptConfig(lr=3e-4, warmup_steps=2, total_steps=steps)
    decay = math.prod(1.0 - float(opt.schedule(torch.tensor(s), ocfg))
                      * ocfg.weight_decay for s in range(steps))
    unread, worst = [], 0.0
    for (key, p), (_, p0), (_, nu) in zip(tree.paths(state["params"]),
                                          tree.paths(init),
                                          tree.paths(state["opt"]["nu"])):
        if not key.startswith(UNREAD_TEXT_ONLY):
            continue
        unread.append(key)
        check(not nu.any(), f"[train] {WHISPER}: {key} has a gradient")
        want = p0 * (decay if p0.dim() >= 2 else 1.0)
        scale = max(float(p0.abs().max()), 1e-30)
        worst = max(worst, float((p - want).abs().max()) / scale)
    step_ms = statistics.median(res["step_s"][1:]) * 1e3
    print(f"[train] {WHISPER} full width and depth, text only, batch 8 x L "
          f"448, {steps} steps: losses "
          + " ".join(f"{v:.4f}" for v in res["losses"])
          + f"; median step {step_ms:.1f} ms; peak {peak:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held before; "
          f"{len(unread)} leaves no text-only call reads (the cross "
          f"branches, the encoder, enc_norm, cross_k/v): second moments 0, "
          f"moved by weight decay only (max relative deviation "
          f"{worst:.2e}); {SMI}")
    check(all(math.isfinite(v) for v in res["losses"]),
          f"[train] {WHISPER}: a loss is not finite")
    check(worst <= 1e-6, f"[train] {WHISPER}: an unread leaf moved by more "
          "than weight decay")
    del res, state, init
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": step_ms}


def encdec_phase(torch) -> tuple[dict, dict, dict]:
    """Phase 13, ``[encdec]``: (a) the kernels at whisper's W64 geometry,
    (b) whisper-tiny at full width, (c) internvl2-26b at full width and
    depth, (d) card = CPU at ``reduced()``, (e) whisper trained.  Returns
    (the W64 worst errors, the W64 timings, the phase's launches of rows
    1-3 summed over (b) and (c))."""
    t0 = time.perf_counter()
    worst, timings = encdec_kernels(torch)
    counts = whisper_full_width(torch)
    vision = vision_full_width(torch)
    for k, v in vision["counts"].items():
        counts[k] = counts.get(k, 0) + v
    encdec_agreement(torch)
    train_whisper(torch)
    print(f"[encdec] phase took {time.perf_counter() - t0:.1f}s")
    return worst, timings, counts


# ---------------------------------------------------------------------------
# phase 14, [pim]
# ---------------------------------------------------------------------------

# what (b) quickstart and (c) kernel_bench launch: one masked product,
# volume and decode call, then a masked product per B and a grouped GEMM
# per T
PIM_LAUNCHES = {"ssgemm_masked": 3, "wavesim_volume": 1, "decode_attn": 1,
                "group_gemm": 2}


def pim_model_vs_card(torch, timings: dict, flux_ms: float) -> None:
    """(d) The paper's GPU model at the card's HBM rate (90% of 3.35 TB/s)
    beside the card's time for the same ``Problem``, from the earlier
    phases' timings: vector-sum (64 Mi float16, device-only graph ms),
    the volume term (``Problem()``, bfloat16 device-only graph ms), the
    flux (``Problem()``, the wave step's plain flux and update in float32)
    and ss-gemm (``Problem()`` N 2-16, bfloat16 ``make_skinny`` B, the
    tensor-core walk's ms).  Printed, not gated."""
    import dataclasses
    from repro_torch.core.hwspec import DEFAULT_GPU, DEFAULT_HOPPER
    from repro_torch.core.primitives import ss_gemm, vector_sum, wavesim
    gpu = dataclasses.replace(DEFAULT_GPU,
                              peak_hbm_gbps=DEFAULT_HOPPER.hbm_gbps)
    vp, wp = vector_sum.Problem(n=64 << 20), wavesim.Problem()
    rows = [("vector-sum 64 Mi fp16", 3 * vp.bytes_per_array,
             vector_sum.gpu_time_ns(vp, gpu),
             timings["vector_sum"]["graph_ms"], "vector_sum float16, device"),
            ("wavesim-volume Problem()", wp.volume_bytes,
             wavesim.gpu_time_volume_ns(wp, gpu),
             timings["wavesim_volume"]["bf16_graph_ms"],
             "volume bfloat16, device"),
            ("wavesim-flux Problem()", wp.flux_bytes,
             wavesim.gpu_time_flux_ns(wp, gpu), flux_ms,
             "plain flux + update float32, events")]
    for n in (2, 4, 8, 16):
        sp = ss_gemm.Problem(n=n)
        row_zero = ss_gemm.measured_sparsity(ss_gemm.make_skinny(sp, SEED))[1]
        model_ns = ss_gemm.gpu_time_ns(sp, gpu, row_zero)
        rows.append((f"ss-gemm Problem() N {n}", model_ns * gpu.effective_gbps,
                     model_ns, timings["ssgemm_masked_by_n"][n],
                     "ssgemm_masked bfloat16, events"))
    for name, nbytes, model_ns, card_ms, how in rows:
        print(f"[pim] (d) {name}: {nbytes:.0f} B, model {model_ns / 1e6:.4f} "
              f"ms at 90% of {gpu.peak_hbm_gbps:.0f} GB/s, card {card_ms:.4f} "
              f"ms ({how}), card / model {card_ms / (model_ns / 1e6):.3f}; "
              f"{SMI}")


def pim_phase(torch, timings: dict, flux_ms: float) -> dict:
    """Phase 14, ``[pim]``: (a) ``launch.figures.run`` in full (the
    paper's model, host arithmetic) with the headline averages finite;
    then, with the launch counts set to 0, (b) ``launch.quickstart`` on
    the card, its three kernels against their plain versions, and (c)
    ``launch.figures.kernel_bench`` on the card: ``block_occupancy`` equal
    to numpy's count, the masked products within the float32 bound of the
    float64 oracle, and the grouped GEMM's tiles counted on the card equal
    to ``tile_counts`` at T 128 and 4,096 (full deepseek-v3 expert width);
    the counts read right after must be :data:`PIM_LAUNCHES`.  (d) the
    model beside the card (:func:`pim_model_vs_card`).  Returns the
    launches of (b) and (c)."""
    import numpy as np
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import moe_group_gemm as mg
    from repro_torch.kernels import ss_gemm as sg
    from repro_torch.kernels import wavesim_volume as wv
    from repro_torch.launch import quickstart
    from repro_torch.launch.figures import kernel_bench
    from repro_torch.launch.figures import run as figures_run
    t0 = time.perf_counter()
    figs = figures_run.run()
    avg = figs["headline"]
    check(len(figs) == len(figures_run.TABLES)
          and all(math.isfinite(v) for v in avg.values()),
          "[pim] (a) a table is missing or a headline average not finite")
    print(f"[pim] (a) launch.figures.run, every table, in "
          f"{time.perf_counter() - t0:.1f}s: headline avg_baseline "
          f"{avg['avg_baseline']!r}, avg_optimized {avg['avg_optimized']!r} "
          f"(the paper's model, host arithmetic)")

    mods = (sg, wv, da, mg)
    for mod in mods:
        mod.reset_launch_counts()
    t1 = time.perf_counter()
    qs = quickstart.run("cuda")
    kb = kernel_bench.run("cuda")
    torch.cuda.synchronize()
    counts = {k: v for mod in mods for k, v in mod.launch_counts.items()
              if k in PIM_LAUNCHES}
    t_run = time.perf_counter() - t1

    a, b = qs["ss-gemm"]["inputs"]
    a64, b64 = a.double(), b.double()
    ok, err, ratio = summed_within(qs["ss-gemm"]["out"], a64 @ b64,
                                   a64.abs() @ b64.abs(), a.shape[1])
    check(ok, f"[pim] (b) quickstart ss-gemm outside the float32 bound "
          f"(err {err:.3e}, {ratio:.2f} of it)")
    (u,) = qs["wavesim-volume"]["inputs"]
    w64 = wv.fused_operator(1.0, torch.float32).double()
    vok, verr, vratio = volume_within(
        torch, qs["wavesim-volume"]["out"].reshape(-1, 27),
        u.reshape(-1, 27).double(), w64)
    check(vok, f"[pim] (b) quickstart volume outside the float32 bound "
          f"(err {verr:.3e}, {vratio:.2f} of it)")
    derr = qs["decode-attn"]["max_abs_err"]
    check(derr <= TOL["float32"], f"[pim] (b) quickstart decode_attn "
          f"differs from its plain version by {derr:.3e}")
    print(f"[pim] (b) quickstart on the card, float32 at the JAX example's "
          f"shapes: ss-gemm {err:.3e} ({ratio:.3f} of the float32 bound), "
          f"volume {verr:.3e} ({vratio:.3f} of its bound), decode_attn "
          f"{derr:.3e} (limit {TOL['float32']:.0e}) vs the plain versions")

    parts = []
    for kind, r in kb["ss_gemm"].items():
        b_np = r["b"].float().cpu().numpy()
        live = (b_np != 0).reshape(-1, kernel_bench.BK, b_np.shape[1]).any(
            axis=(1, 2)).astype(np.int32)
        check(np.array_equal(r["occupancy"], live),
              f"[pim] (c) block_occupancy on the card != numpy's ({kind})")
        a64, b64 = r["a"].double(), r["b"].double()
        ok, err, ratio = summed_within(r["out"], a64 @ b64,
                                       a64.abs() @ b64.abs(), kernel_bench.K)
        check(ok, f"[pim] (c) ssgemm_masked ({kind}) outside the float32 "
              f"bound of the float64 oracle (err {err:.3e})")
        parts.append(f"{kind} B {int(live.sum())}/{live.size} blocks live "
                     f"(= numpy), masked {err:.3e} ({ratio:.3f} of the bound)")
    for tokens, r in kb["moe"].items():
        check(r["kernel_tiles"] == r["tile_counts"],
              f"[pim] (c) group_gemm tiles at T {tokens}: card "
              f"{r['kernel_tiles']}, tile_counts {r['tile_counts']}")
        total, skipped = r["kernel_tiles"]
        parts.append(f"group_gemm T {tokens} (C {r['cap']}): "
                     f"{total - skipped}/{total} tiles run (= tile_counts; "
                     f"JAX's bc-128 count {r['jax_live']}/{r['jax_tiles']})")
    print("[pim] (c) kernel_bench on the card: " + "; ".join(parts))
    check(counts == PIM_LAUNCHES, f"[pim] launches {counts}, expected "
          f"{PIM_LAUNCHES}")
    print(f"[pim] (b) + (c) took {t_run:.1f}s; launches {counts}")
    del qs, kb
    gc.collect()
    torch.cuda.empty_cache()
    pim_model_vs_card(torch, timings, flux_ms)
    print(f"[pim] phase took {time.perf_counter() - t0:.1f}s")
    return counts


def _cast(torch, tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(torch, v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(torch, v, dtype) for v in tree]
    return tree.to(dtype)


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
        from repro_torch.kernels.moe_group_gemm import kernel as group_kernel
        from repro_torch.kernels.paged_attn import kernel as paged_kernel
        from repro_torch.kernels.push_scatter import kernel as push_kernel
        from repro_torch.kernels.ss_gemm import kernel as ssgemm_kernel
        from repro_torch.kernels.vector_sum import kernel as vsum_kernel
        from repro_torch.kernels.wavesim_flux import kernel as flux_kernel
        from repro_torch.kernels.wavesim_volume import kernel as vol_kernel
        from repro_torch.launch import sass_check
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
    global SMI
    SMI = smi
    print(f"[device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; allow_tf32 off for matmul and cuDNN")

    def build(mod):
        t0 = time.perf_counter()
        mod.load_extension()
        return time.perf_counter() - t0
    t0 = time.perf_counter()
    mods = {"paged attention": paged_kernel, "decode_attn": dense_kernel,
            "ss_gemm": ssgemm_kernel, "push_scatter": push_kernel,
            "wavesim_volume": vol_kernel, "wavesim_flux": flux_kernel,
            "vector_sum": vsum_kernel, "moe_group_gemm": group_kernel}
    with concurrent.futures.ThreadPoolExecutor(len(mods) + 1) as pool:
        # beside the builds: what the volume kernel compiles to
        sass = pool.submit(
            sass_check.report,
            pathlib.Path(vol_kernel.__file__).parent / "csrc" / "volume.cu",
            vol_kernel.STAGES)
        secs = dict(zip(mods, pool.map(build, mods.values())))
        sass = sass.result()
    print(f"[build] {len(mods)} extensions built at once in "
          f"{time.perf_counter() - t0:.1f}s ("
          + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()) + ")")
    for line in sass_check.lines(sass):
        print(line)
    check(sass_check.stencil_loop_ok(sass),
          "wavesim_volume: the stencil's multiply-adds do not compile to "
          "189 FFMAs a row with constant-bank weights and no LDC, LDL or "
          "STL among them, or the kernel spills")

    worst = kernel_checks(torch)
    kernel_checks(torch, MOE_GEO)
    for _, geo in FAMILIES.values():
        kernel_checks(torch, geo)
    worst["decode_attn"] = stripe_checks(torch)
    worst["group_gemm"] = group_gemm_checks(torch)
    deepseek_group_gemm_checks(torch)
    ssgemm_checks(torch)
    push_checks(torch)
    wave_kernel_checks(torch)
    timings = kernel_timings(torch)
    timings["paged_prefill"].update(verify_timing(torch))
    timings["decode_attn"] = stripe_timing(torch)
    at_d128 = kernel_timings(torch, MOE_GEO, layers=48)
    at_d128["decode_attn"] = stripe_timing(torch, MOE_GEO, layers=48)
    for name, row in at_d128.items():
        timings[name].update({f"d128_{k}": row[k] for k in (
            "ms", "library_ms", "bound_ms", "flops", "graph_ms",
            "library_graph_ms", "host_us", "splits", "bytes") if k in row})
    from repro_torch.configs import get_config
    for arch, (tag, geo) in FAMILIES.items():
        layers = get_config(arch).n_layers
        at_geo = kernel_timings(torch, geo, layers=layers)
        at_geo["decode_attn"] = stripe_timing(torch, geo, layers=layers)
        for name, row in at_geo.items():
            timings[name].update({f"{tag}_{k}": row[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "flops", "graph_ms", "library_graph_ms", "host_us", "splits",
                "bytes") if k in row})
    timings["group_gemm"] = group_gemm_timing(torch)
    timings["group_gemm"].update(deepseek_group_gemm_timing(torch))
    timings.update(primitive_timings(torch))
    timings.update(wave_timings(torch))
    redesign_line(timings)
    for name in ("ssgemm_masked", "ssgemm_compact", "push_scatter",
                 "wavesim_volume", "flux1d", "vector_sum"):
        worst[name] = timings[name]["max_abs_err"]
    from repro_torch.models.model_zoo import Model
    params = Model(get_config(ARCH)).init(0, device="cuda",
                                          dtype=torch.bfloat16)
    paged_ref, counts = serve_full_width(torch, params, paged=True)
    dense_counts = serve_full_width(torch, params, paged=False)[1]
    counts["decode_attn"] = dense_counts["decode_attn"]
    feature_streams = serve_features(torch, params)
    serve_preempt(torch, params, paged_ref)
    serve_overload(torch, params, paged_ref, feature_streams)
    tuned = autotune_phase(torch, params)
    del paged_ref
    del params
    dense_join_rows(torch)
    agreement(torch)
    counts.update(primitives_ss_gemm(torch))
    counts.update(primitives_push(torch))
    wave_counts, flux_ms = wave_path(torch)
    counts.update(wave_counts)
    moe_agreement(torch)
    counts["group_gemm"] = moe_serve(torch)["group_gemm"]
    families = families_serve(torch)
    families_agreement(torch)
    # phase 11, [ssm]: zamba2's attention geometry, both SSM models served
    # at full width, card = CPU at reduced(), the padding invariant
    t_ssm = time.perf_counter()
    ssm_worst, at_z64 = ssm_kernels(torch)
    for name, row in at_z64.items():
        timings[name].update({f"z64_{k}": row[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "flops",
            "graph_ms", "library_graph_ms", "host_us", "splits", "bytes")
            if k in row})
        timings[name]["z64_max_abs_err"] = ssm_worst[name]
    ssm_counts = ssm_serve(torch)
    families_agreement(torch, SSM_ARCHS)
    ssm_padding_invariant(torch)
    print(f"[ssm] phase took {time.perf_counter() - t_ssm:.1f}s")
    # phase 12, [train]: the grouped GEMM's backward, full-width qwen and
    # the moonshot cut trained on the card, card = CPU at reduced()
    timings["group_gemm"].update(train_phase(torch))
    # phase 13, [encdec]: whisper's W64 geometry, whisper-tiny and
    # internvl2-26b at full width, card = CPU at reduced(), whisper trained
    enc_worst, at_w64, encdec_counts = encdec_phase(torch)
    for name, row in at_w64.items():
        timings[name].update({f"w64_{k}": row[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "flops",
            "graph_ms", "library_graph_ms", "host_us", "splits", "bytes")
            if k in row})
        timings[name]["w64_max_abs_err"] = enc_worst[name]
    # phase 14, [pim]: the paper's model and its drivers, quickstart's and
    # kernel_bench's kernels on the card, the model beside the card
    pim_counts = pim_phase(torch, timings, flux_ms)

    sources = {"paged_decode": ("src/repro_torch/kernels/paged_attn/csrc/"
                                "paged_decode.cu",
                                "src/repro/kernels/paged_attn/kernel.py:107"),
               "paged_prefill": ("src/repro_torch/kernels/paged_attn/csrc/"
                                 "paged_prefill_tc.cu",
                                 "src/repro/kernels/paged_attn/"
                                 "prefill_kernel.py:138"),
               "decode_attn": ("src/repro_torch/kernels/decode_attn/csrc/"
                               "decode_attn.cu",
                               "src/repro/kernels/decode_attn/kernel.py:82"),
               "ssgemm_masked": ("src/repro_torch/kernels/ss_gemm/csrc/"
                                 "ss_gemm_tc.cu",
                                 "src/repro/kernels/ss_gemm/kernel.py:51"),
               "ssgemm_compact": ("src/repro_torch/kernels/ss_gemm/csrc/"
                                  "ss_gemm_tc.cu",
                                  "src/repro/kernels/ss_gemm/kernel.py:94"),
               "push_scatter": ("src/repro_torch/kernels/push_scatter/csrc/"
                                "push_scatter.cu",
                                "src/repro/kernels/push_scatter/kernel.py:51"),
               "wavesim_volume": ("src/repro_torch/kernels/wavesim_volume/"
                                  "csrc/volume.cu",
                                  "src/repro/kernels/wavesim_volume/"
                                  "kernel.py:51"),
               "flux1d": ("src/repro_torch/kernels/wavesim_flux/csrc/"
                          "flux1d.cu",
                          "src/repro/kernels/wavesim_flux/kernel.py:26"),
               "vector_sum": ("src/repro_torch/kernels/vector_sum/csrc/"
                              "vector_sum.cu",
                              "src/repro/kernels/vector_sum/kernel.py:21"),
               "group_gemm": ("src/repro_torch/kernels/moe_group_gemm/csrc/"
                              "group_gemm.cu",
                              "src/repro/kernels/moe_group_gemm/"
                              "kernel.py:39")}
    rows = []
    for name, (src, replaces) in sources.items():
        t = timings[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": worst[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
        # the group_gemm row is the decode call, the join's calls beside
        # it; the attention rows are at qwen's geometry, moonshot's beside;
        # the decode rows add device-only times (graph_ms, SDPA's
        # library_graph_ms), the wrapper's host_us and their split count
        rows[-1].update({k: v for k, v in t.items()
                         if (k.startswith(("tiles", "prefill_", "down_",
                                           "d128_", "n16_", "bf16_",
                                           "verify_", "ds_", "z64_", "w64_",
                                           "bwd_", "train_",
                                           *(t + "_" for t, _ in
                                             FAMILIES.values())))
                             or k in ("graph_ms", "library_graph_ms",
                                      "host_us", "splits"))
                         and not k.endswith(("flops", "bytes"))})
        if name in ("paged_decode", "paged_prefill"):
            # this run's sweep at both geometries: default and winner
            ops_of = (("decode",) if name == "paged_decode"
                      else ("prefill", "verify"))
            rows[-1]["autotune"] = {
                geo: {op: {"winner": r[op]["winner"],
                           "winner_graph_ms": r[op]["winner_ms"],
                           "default_graph_ms": r[op]["default_ms"],
                           "measured": len(r[op]["candidates"]),
                           "parity_dropped": len(r[op]["parity_dropped"])}
                      for op in ops_of}
                for geo, r in tuned.items()}
        # the [families] phase's launches: the three dense models' (both
        # attention kernels) and the deepseek cut's grouped GEMMs
        if name in ("paged_decode", "paged_prefill"):
            rows[-1]["families_launches"] = families[name]
        # the [ssm] phase's: zamba2's shared block, paged and dense
        if name in ("paged_decode", "paged_prefill", "decode_attn"):
            rows[-1]["ssm_launches"] = ssm_counts[name]
            # the [encdec] phase's: whisper and internvl2, (b) and (c)
            rows[-1]["encdec_launches"] = encdec_counts[name]
        if name == "group_gemm":
            rows[-1]["deepseek_launches"] = families["deepseek_group_gemm"]
        # the [pim] phase's: quickstart and kernel_bench
        if name in pim_counts:
            rows[-1]["pim_launches"] = pim_counts[name]
        if name == "group_gemm":     # the join's calls take the wgmma file
            rows[-1]["prefill_source"] = ("src/repro_torch/kernels/"
                                          "moe_group_gemm/csrc/"
                                          "group_gemm_sm90.cu")
        if name.startswith("ssgemm"):  # float32 and ragged K: CUDA cores
            rows[-1]["cuda_core_source"] = ("src/repro_torch/kernels/"
                                            "ss_gemm/csrc/ss_gemm.cu")
        # no single PyTorch call computes flux1d's pair of periodic
        # differences, so its library_ms is null, and that row's alone
        check(all(isinstance(v, (int, float)) and math.isfinite(v)
                  for k, v in rows[-1].items()
                  if k.endswith("_ms") or k == "ms"
                  if not (k == "library_ms" and name == "flux1d"
                          and v is None)),
              f"{name}: a timing is not a finite number")
        check(counts[name] > 0, f"{name}: not launched on its path")
        check(rows[-1].get("families_launches", 1) > 0
              and rows[-1].get("deepseek_launches", 1) > 0,
              f"{name}: not launched on the [families] phase's path")
        check(rows[-1].get("ssm_launches", 1) > 0,
              f"{name}: not launched on the [ssm] phase's path")
        check(rows[-1].get("encdec_launches", 1) > 0,
              f"{name}: not launched on the [encdec] phase's path")
        check(rows[-1].get("train_launches", 1) > 0,
              f"{name}: not launched on the [train] phase's path")
        check(rows[-1].get("pim_launches", 1) > 0,
              f"{name}: not launched on the [pim] phase's path")
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
