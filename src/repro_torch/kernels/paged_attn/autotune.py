"""Autotuning harness for the paged-attention kernels, from
:mod:`repro.kernels.paged_attn.autotune`: the same structure (enumerate,
prune, benchmark, parity-gate, persist), with Hopper launch knobs.

The Pallas kernels' knobs were ``grid_order`` (the order of the grid's
(batch, head) axes on the TPU's sequential grid) and ``block_rows``.  The
GPU's block scheduler runs CTAs in parallel in no fixed order, so it has
no grid-order axis worth a knob.  The knobs here are:

* decode (``paged_decode.cu``): ``ctas_per_sm`` in 1, 2, 4, 8, the CTA
  target an SM of :func:`.split.split_count` (a target, not a split
  count, so one tuned entry stays right at every batch), and ``cta_rows``
  in 1, 2, 4, the query rows a CTA keeps;
* prefill and verify (``paged_prefill_tc.cu``, ``paged_prefill.cu``):
  ``block_rows`` in 16, 32, 64, the fused (token, group) rows a CTA.

The default :class:`Candidate` (2, 2, 64) is the launch the kernels ran
before the knobs existed.

1. **Enumerate** the candidates of an op, the default first.  Page size
   is a *geometry* axis, not a candidate axis: it changes the pool.
2. **Prune** with :func:`feasible` (shared memory a CTA, the cluster
   limit, the key bound's tiles, rows in whole 16-row MMA tiles: a
   refused candidate never runs, and says why) and the analytic
   :func:`score`: the roofline max of :func:`candidate_traffic`'s bytes
   over the card's memory rate and flops over its dtype peak, plus a
   charge per wave of CTAs; the rest is ranked and cut to ``budget``,
   the default always kept and first.
3. **Benchmark** the survivors.  On a CUDA workload each candidate's
   device time per call comes from :func:`repro_torch.launch.timing.
   graph_ms` (the calls captured in one CUDA graph and replayed), the
   measure of ``PERF.md``'s "device" column.  On a CPU workload the ops
   take their plain route, the knobs change nothing, and the time is the
   telemetry's wall time (as JAX times its XLA route): a CPU sweep checks
   the harness, not the kernels.  Every candidate's output is
   **parity-gated** against the default's: splitting the keys another way
   changes the order of the softmax sums, so a candidate is dropped when
   its max abs difference exceeds the attention gates of
   ``chip_smoke.py`` (bf16 2e-2, float32 1e-4), and each row says whether
   it was bit-exact.
4. **Persist** the winners (device-time argmin, the default included, so
   never slower than it) to a versioned JSON cache, by default this
   package's ``tuned_shapes.json``, keyed
   ``"<device type>|<op>|hq{H}.hkv{K}.d{D}.ps{P}"``, with the card's name
   and power limit as nvidia-smi gives them.
   :class:`repro_torch.kernels.decode_attn.ops.DecodeAttnPolicy` loads
   the cache when it is built and the ops consult it per call shape; the
   ``REPRO_TORCH_TUNED_SHAPES`` environment variable overrides the path
   or (``0`` / ``off`` / ``ignore`` / ``none`` / empty) disables loading.

Cache schema (``SCHEMA == 1``)::

    {"schema": 1,
     "entries": {"cuda|verify|hq14.hkv2.d64.ps16": {
         "config": {"block_rows": 16},            # winner launch
         "ms": ..., "default_ms": ...,            # device ms a call
         "achieved_gbps": ..., "op_byte": ...,
         "card": "NVIDIA H100 80GB HBM3, 700.00 W",
         "workload": "...", "geometry": "...", "op": "verify"}}}

``python -m repro_torch.launch.autotune`` drives the sweep on the card.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess

import numpy as np
import torch

from ...core.hwspec import DEFAULT_HOPPER, HopperSpec
from . import kernel, split

SCHEMA = 1
OPS = ("decode", "prefill", "verify")
ENV_VAR = "REPRO_TORCH_TUNED_SHAPES"
_ENV_OFF = ("", "0", "off", "ignore", "none")
DEFAULT_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tuned_shapes.json")
# analytic charge per wave of CTAs over the card's SMs (ns).  A ranking
# device, not a measurement: a launch that needs more waves pays for each
# one at roughly a CTA's fixed start-up and tail.
WAVE_NS = 1000.0
# the parity gate: chip_smoke.py's attention tolerances
PARITY_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The model/pool shape a tuned entry is keyed by.  Lq and the batch
    are *not* part of the key: one entry serves every chunk length and
    every batch (``ctas_per_sm`` is a target, and a ragged last row block
    is fine)."""
    hq: int
    hkv: int
    d: int
    page_size: int

    @property
    def g(self) -> int:
        return self.hq // self.hkv

    def key(self) -> str:
        return (f"hq{self.hq}.hkv{self.hkv}.d{self.d}"
                f".ps{self.page_size}")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One launch configuration; the defaults are the kernels' launch
    without a tuned entry.  Decode reads ``ctas_per_sm`` and
    ``cta_rows``, prefill and verify ``block_rows``."""
    ctas_per_sm: int = split.CTAS_PER_SM
    cta_rows: int = split.CTA_ROWS
    block_rows: int = kernel.BLOCK_ROWS

    def as_dict(self, op: str) -> dict:
        if op == "decode":
            return {"ctas_per_sm": self.ctas_per_sm,
                    "cta_rows": self.cta_rows}
        return {"block_rows": self.block_rows}

    def label(self, op: str) -> str:
        if op == "decode":
            return f"cps={self.ctas_per_sm}/rows={self.cta_rows}"
        return f"br={self.block_rows}"


def entry_key(backend: str, op: str, geom: Geometry) -> str:
    return f"{backend}|{op}|{geom.key()}"


@dataclasses.dataclass
class Workload:
    """Concrete tensors for one (op, geometry) benchmark point."""
    op: str
    geom: Geometry
    q: torch.Tensor
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    table: torch.Tensor
    lengths: torch.Tensor
    q_offset: torch.Tensor | None     # None for decode
    lq: int                           # 1 for decode

    @property
    def lg(self) -> int:
        """Fused query rows a (slot, KV head) of the kernel."""
        return self.geom.g if self.op == "decode" else self.lq * self.geom.g

    @property
    def key_bound(self) -> int:
        """Keys of the sliced table: the decode split's bound."""
        return int(self.table.shape[1]) * self.geom.page_size

    def describe(self) -> str:
        ln = _host(self.lengths)
        if self.op == "decode":
            what = f"lengths {ln.min()}-{ln.max()}"
        else:
            off = _host(self.q_offset)
            what = (f"Lq {self.lq}, q_offset {off.min()}-{off.max()}, "
                    f"kv_len {ln.min()}-{ln.max()}")
        return (f"{self.op} B={self.q.shape[0]} {what}, "
                f"{self.k_pages.shape[0]} pages, "
                f"{str(self.q.dtype).split('.')[1]}")


def _host(x) -> np.ndarray:
    return x.detach().reshape(-1).to("cpu", torch.int64).numpy()


def make_workload(op: str, geom: Geometry, *, b: int = 2, lq: int = 8,
                  pages: int | None = 16, seed: int = 0,
                  depths: tuple[int, int] | None = None,
                  device: str | torch.device = "cpu",
                  dtype: torch.dtype = torch.float32) -> Workload:
    """Random pooled-page workload in the shape the serving engine hands
    the kernels: a permuted page table, live lengths inside the sliced
    table.  The data comes from ``numpy.random.default_rng(seed)``, drawn
    in JAX's order, then is cast to ``dtype`` on ``device``: with
    ``depths`` None the arrays are JAX's ``make_workload``'s for the same
    arguments (offsets at least one page deep), and nothing touches
    torch's global generator.

    ``depths`` = (lo, hi) draws the serve cells' depths instead: decode
    lengths in [lo, hi]; verify decode depths with the Lq rows inside
    [lo, hi]; prefill a whole-prompt join (``q_offset`` 0) of prompts of
    lo to hi tokens padded to ``lq``.  ``pages`` None sizes the pool to
    the deepest slot: ``b`` x ceil(hi / page size) pages."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    ps, hkv, hq, d = geom.page_size, geom.hkv, geom.hq, geom.d
    if pages is None:
        if depths is None:
            raise ValueError("pages=None needs depths")
        pages = b * -(-max(depths[1], lq) // ps)
    if pages % b:
        raise ValueError(f"pages={pages} must be divisible by b={b}")
    p_max = pages // b
    if depths is None and op != "decode" and (p_max - 1) * ps - lq <= ps:
        raise ValueError(f"workload too small: need (pages/b - 1) * "
                         f"page_size > page_size + lq "
                         f"(pages={pages}, b={b}, ps={ps}, lq={lq})")
    if depths is not None and depths[1] > p_max * ps:
        raise ValueError(f"depths {depths} exceed the table's "
                         f"{p_max * ps} keys")
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((pages, ps, hkv, d))
    vp = rng.standard_normal((pages, ps, hkv, d))
    tbl = rng.permutation(pages)[:b * p_max].reshape(b, p_max)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)
    i32 = torch.int32
    if op == "decode":
        q = rng.standard_normal((b, hq, d))
        ln = (rng.integers(ps, p_max * ps, size=b) if depths is None
              else rng.integers(depths[0], depths[1] + 1, size=b))
        return Workload(op, geom, dev(q), dev(kp), dev(vp), dev(tbl, i32),
                        dev(ln, i32), None, 1)
    q = rng.standard_normal((b, lq, hq, d))
    if depths is None:
        off = rng.integers(ps, (p_max - 1) * ps - lq, size=b)
        kvl = off + lq
    elif op == "verify":
        off = rng.integers(depths[0], depths[1] - lq + 1, size=b)
        kvl = off + lq
    else:
        off = np.zeros(b, np.int64)
        kvl = rng.integers(depths[0], depths[1] + 1, size=b)
    return Workload(op, geom, dev(q), dev(kp), dev(vp), dev(tbl, i32),
                    dev(kvl, i32), dev(off, i32), lq)


def enumerate_candidates(op: str, lg: int | None = None) -> list[Candidate]:
    """Every launch the kernels accept for ``op``, the default
    ``Candidate()`` first (the pruner keeps it, and the benchmark gates
    every other candidate against it): decode every (``ctas_per_sm``,
    ``cta_rows``) pair, prefill and verify every ``block_rows``.  ``lg``
    (the fused row count) is taken for JAX's signature: the port's row
    blocks may be ragged, so no row tiling depends on it."""
    default = Candidate()
    if op == "decode":
        cands = [Candidate(ctas_per_sm=c, cta_rows=r)
                 for c in split.CTAS_PER_SM_CHOICES
                 for r in split.CTA_ROWS_CHOICES]
    else:
        cands = [Candidate(block_rows=br)
                 for br in kernel.BLOCK_ROWS_CHOICES]
    return [default] + [c for c in cands if c != default]


def smem_bytes(op: str, cand: Candidate, geom: Geometry,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory a CTA of ``cand``'s launch takes: the
    ``smem_bytes`` / ``Layout`` formulas of the CUDA sources."""
    d = geom.d
    if op == "decode":
        # decode_split.cuh: staged page ids, then 4 warps' + the CTA's
        # (acc [rows][D], m [rows], l [rows]) states
        rows = 1
        while rows < geom.g and rows < cand.cta_rows:
            rows *= 2
        return 4 * 256 + 4 * (4 + 1) * rows * (d + 2)
    rows = cand.block_rows
    if dtype == torch.bfloat16:
        # paged_prefill_tc.cu Layout: 2 K + 2 V tiles of 64 padded rows,
        # the row offsets and positions
        return 4 * 64 * (d + 8) * 2 + rows * 12
    # paged_attn_common.cuh smem_bytes<D, 32, rows>
    tile = 32
    return (tile * 8 + rows * 12
            + 4 * (rows * (d + 1) + tile * (d + 1) + tile * d
                   + rows * (tile + 1) + 3 * rows))


def feasible(cand: Candidate, *, op: str, lg: int, geom: Geometry,
             spec: HopperSpec = DEFAULT_HOPPER, batch: int | None = None,
             key_bound: int | None = None,
             dtype: torch.dtype = torch.bfloat16) -> tuple[bool, str]:
    """Static feasibility: a refused candidate never runs.  Refuses a knob
    of the other op's kernel, a value the kernels are not instantiated
    for (``block_rows`` not a whole number of 16-row MMA tiles, or above
    the 64-key tile buffer the q rows are staged in), shared memory a CTA
    past ``spec.smem_per_cta``, and (decode, with the workload's
    ``batch`` and ``key_bound``) a split of more ranks a cluster than
    ``spec.max_cluster`` or than the key bound has tiles."""
    default = Candidate()
    if op == "decode":
        if cand.block_rows != default.block_rows:
            return False, "decode has no query-row block to tile"
        if cand.cta_rows not in split.CTA_ROWS_CHOICES:
            return False, (f"cta_rows={cand.cta_rows} is not instantiated "
                           f"(the decode kernel keeps "
                           f"{split.CTA_ROWS_CHOICES} rows a CTA)")
        if not isinstance(cand.ctas_per_sm, int) or cand.ctas_per_sm < 1:
            return False, f"ctas_per_sm={cand.ctas_per_sm!r} is not >= 1"
    else:
        if (cand.ctas_per_sm, cand.cta_rows) != (default.ctas_per_sm,
                                                  default.cta_rows):
            return False, f"{op} has no split-KV walk to size"
        br = cand.block_rows
        if not isinstance(br, int) or br <= 0 or br % 16:
            return False, (f"block_rows={br} is not a whole number of "
                           "16-row MMA tiles (one warp each)")
        if br > 64:
            return False, (f"block_rows={br} exceeds the 64-key tile "
                           "buffer the CTA's q rows are staged in")
        if br not in kernel.BLOCK_ROWS_CHOICES:
            return False, (f"block_rows={br} is not instantiated "
                           f"({kernel.BLOCK_ROWS_CHOICES})")
    smem = smem_bytes(op, cand, geom, dtype)
    if smem > spec.smem_per_cta:
        return False, (f"shared memory {smem} B a CTA exceeds "
                       f"{spec.smem_per_cta} B")
    if op == "decode" and batch is not None and key_bound is not None:
        splits = split.split_count(batch, geom.hkv, geom.g, key_bound,
                                   spec.sms, cand.ctas_per_sm,
                                   cand.cta_rows)
        if splits > spec.max_cluster:
            return False, (f"{splits} ranks a cluster exceed the portable "
                           f"cluster of {spec.max_cluster}")
        tiles = -(-max(key_bound, 0) // split.TILE)
        if splits > max(tiles, 1):
            return False, (f"{splits} ranks a cluster exceed the key "
                           f"bound's {tiles} tiles")
    return True, "ok"


def _page_fetches(wl: Workload, block_rows: int | None) -> int:
    """Physical K/V page fetches across the whole launch for a row
    tiling: each row block re-walks the page list, but only up to its own
    causal top (the kernels stop the walk there).  ``block_rows`` None is
    one block of all rows, as in JAX; the port's last block may be
    ragged, and for a ``block_rows`` that divides the rows this is JAX's
    count."""
    p_max = int(wl.table.shape[1])
    ps = wl.geom.page_size
    ln = _host(wl.lengths)
    if wl.op == "decode":
        end = np.clip(ln, 0, p_max * ps)
        return int(np.sum((end + ps - 1) // ps))
    off = _host(wl.q_offset)
    lg = wl.lg
    br = lg if block_rows is None else block_rows
    g = wl.geom.g
    total = 0
    for r in range(-(-lg // br)):
        last = min(r * br + br, lg) - 1
        top = off + last // g                     # deepest qpos in block
        end = np.clip(np.minimum(ln, top + 1), 0, p_max * ps)
        total += int(np.sum((end + ps - 1) // ps))
    return total


def candidate_traffic(wl: Workload, cand: Candidate) -> tuple:
    """Per-candidate ``(mem_bytes, flops, onchip_bytes)``: the base
    :func:`.ops._traffic` estimate, with the K/V component re-derived
    from the candidate's page-fetch count (row blocks re-walk pages; the
    causal top-skip refunds pages above each block).  Bytes moved from
    on-chip reuse to the re-walk are debited from on-chip reuse."""
    from .ops import _traffic
    mem, flops, onchip = _traffic(wl.q, wl.k_pages, wl.table, wl.lengths,
                                  q_offset=wl.q_offset)
    rows = None if wl.op == "decode" else cand.block_rows
    extra = _page_fetches(wl, rows) - _page_fetches(wl, None)
    if extra > 0:
        item = wl.k_pages.element_size()
        kv = extra * wl.geom.page_size * wl.geom.hkv * wl.geom.d * item * 2
        mem += kv
        onchip = max(0.0, onchip - kv)
    return mem, flops, onchip


def launch_shape(wl: Workload, cand: Candidate,
                 spec: HopperSpec = DEFAULT_HOPPER) -> tuple:
    """What ``cand`` launches at this workload: decode (ranks a cluster,
    rows a CTA, CTAs), prefill and verify (rows a CTA, CTAs).  Two
    candidates with one launch shape run the same kernel on the same
    grid."""
    b = int(wl.q.shape[0])
    if wl.op == "decode":
        splits = split.split_count(b, wl.geom.hkv, wl.geom.g, wl.key_bound,
                                   spec.sms, cand.ctas_per_sm,
                                   cand.cta_rows)
        groups = split.row_groups(wl.geom.g, cand.cta_rows)
        rows = -(-wl.geom.g // groups)
        return splits, rows, b * wl.geom.hkv * groups * splits
    blocks = -(-wl.lg // cand.block_rows)
    return cand.block_rows, b * wl.geom.hkv * blocks


def score(cand: Candidate, wl: Workload,
          spec: HopperSpec = DEFAULT_HOPPER) -> float:
    """Analytic time (ns) for ranking: the roofline max of the
    candidate's bytes over the card's memory rate and its flops over the
    dtype's peak, plus :data:`WAVE_NS` for each wave of CTAs over the
    card's SMs."""
    mem, flops, _onchip = candidate_traffic(wl, cand)
    name = _DTYPE_NAMES.get(wl.q.dtype, "float32")
    roof = max(mem / spec.hbm_gbps, flops / spec.peak_flops_per_ns(name))
    waves = -(-launch_shape(wl, cand, spec)[-1] // spec.sms)
    return roof + waves * WAVE_NS


def prune(wl: Workload, candidates: list[Candidate] | None = None, *,
          budget: int | None = None,
          spec: HopperSpec = DEFAULT_HOPPER) -> tuple[list, list]:
    """(survivors, pruned): feasible candidates ranked by analytic score
    and cut to ``budget``, with the default always surviving (it is the
    parity baseline and the ``default_ms`` reference) and always first.
    A candidate whose launch at this workload is an earlier one's (a CTA
    target the split caps, rows a CTA above G) is pruned as a duplicate.
    ``pruned`` pairs each rejected candidate with its reason."""
    if candidates is None:
        candidates = enumerate_candidates(wl.op, wl.lg)
    default = Candidate()
    order = sorted(candidates, key=lambda c: c != default)
    kept, pruned, seen = [], [], {}
    for c in order:
        ok, why = feasible(c, op=wl.op, lg=wl.lg, geom=wl.geom, spec=spec,
                           batch=int(wl.q.shape[0]),
                           key_bound=wl.key_bound, dtype=wl.q.dtype)
        if ok:
            shape = launch_shape(wl, c, spec)
            if shape in seen:
                ok, why = False, (f"launches what {seen[shape]} launches "
                                  "at this workload")
            else:
                seen[shape] = c.label(wl.op)
        if ok:
            kept.append((score(c, wl, spec), c))
        else:
            pruned.append((c, why))
    kept.sort(key=lambda t: t[0])
    survivors = [c for _, c in kept]
    if budget is not None and budget > 0 and len(survivors) > budget:
        cut = survivors[:budget]
        if default in survivors and default not in cut:
            cut[-1] = default
        pruned.extend((c, "over candidate budget (analytic rank)")
                      for c in survivors if c not in cut)
        survivors = cut
    if default in survivors:
        survivors.remove(default)
        survivors.insert(0, default)
    return survivors, pruned


def _op_call(wl: Workload, cand: Candidate):
    """A call of ``wl``'s op with ``cand``'s knobs given explicitly: on
    the card the kernel's wrapper alone, on a table clamped once (what
    the op launches, without its small clamp and cast kernels, which the
    graph would time with it); on the CPU the op, whose plain route
    ignores the knobs."""
    from . import ops
    if wl.q.device.type == "cuda":
        tbl = ops._clamp_table(wl.table, wl.k_pages.shape[0])
        if wl.op == "decode":
            return lambda i=0: kernel.paged_attn_cuda(
                wl.q, wl.k_pages, wl.v_pages, tbl, wl.lengths,
                ctas_per_sm=cand.ctas_per_sm, cta_rows=cand.cta_rows)
        return lambda i=0: kernel.paged_prefill_attn_cuda(
            wl.q, wl.k_pages, wl.v_pages, tbl, wl.q_offset, wl.lengths,
            block_rows=cand.block_rows)
    if wl.op == "decode":
        return lambda i=0: ops.paged_attn(
            wl.q, wl.k_pages, wl.v_pages, wl.table, wl.lengths,
            ctas_per_sm=cand.ctas_per_sm, cta_rows=cand.cta_rows)
    fn = ops.paged_verify_attn if wl.op == "verify" else \
        ops.paged_prefill_attn
    return lambda i=0: fn(wl.q, wl.k_pages, wl.v_pages, wl.table,
                          wl.q_offset, wl.lengths,
                          block_rows=cand.block_rows)


def benchmark(wl: Workload, candidates: list[Candidate], *,
              reps: int = 3, calls: int = 24) -> tuple[list, list]:
    """Measure ``candidates`` (the default first).  Returns ``(rows,
    dropped)``: one row per candidate that passed the parity gate (its
    config, ``ms`` a call, ``timer``, achieved GB/s and op/byte from
    :func:`candidate_traffic`, ``max_abs_diff`` from the default's output
    and ``bit_exact``), and the gate's casualties with their reason.

    On a CUDA workload ``ms`` is device time: ``calls`` calls in one CUDA
    graph, the median of ``reps`` replays (:func:`repro_torch.launch.
    timing.graph_ms`), of the kernel's wrapper with the candidate's knobs.
    On a CPU workload the ops take their plain route (the knobs are
    ignored there) and ``ms`` is the telemetry's wall time over ``reps``
    eager calls, under ``use_tuned=False``."""
    from ..decode_attn.ops import decode_attn_policy
    from . import ops
    if not candidates or candidates[0] != Candidate():
        raise ValueError("candidates[0] must be the default Candidate(): "
                         "it is the parity and default_ms baseline")
    cuda = wl.q.device.type == "cuda"
    tol = PARITY_TOL[wl.q.dtype]
    tel = ops.attn_telemetry()
    rows, dropped = [], []
    ref = None
    with decode_attn_policy(mode="auto", use_tuned=False):
        for c in candidates:
            call = _op_call(wl, c)
            out = call().float()                 # warm-up, untimed
            if ref is None:
                ref = out
            diff = float((out - ref).abs().max()) if out.numel() else 0.0
            exact = bool(torch.equal(out, ref))
            if not diff <= tol:
                dropped.append({"config": c.as_dict(wl.op),
                                "max_abs_diff": diff,
                                "reason": f"max abs diff {diff:.3e} from "
                                          f"the default's output exceeds "
                                          f"{tol:g}"})
                continue
            if cuda:
                from repro_torch.launch.timing import graph_ms
                ms, timer = graph_ms(call, calls, reps=reps), "device"
            else:
                saved = tel.enabled, tel.stats
                tel.stats, tel.enabled = {}, True
                try:
                    for _ in range(reps):
                        call()
                    snap = next(iter(tel.snapshot().values()))
                finally:
                    tel.enabled, tel.stats = saved
                ms, timer = snap["wall_s"] / max(reps, 1) * 1e3, "wall"
            mem, flops, onchip = candidate_traffic(wl, c)
            rows.append({"config": c.as_dict(wl.op), "ms": ms,
                         "timer": timer,
                         "achieved_gbps": mem / (ms * 1e6) if ms else 0.0,
                         "op_byte": flops / (mem + onchip),
                         "max_abs_diff": diff, "bit_exact": exact})
    return rows, dropped


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def autotune(ops=OPS, *, geom: Geometry, shapes: dict | None = None,
             b: int = 2, lq: int = 8, pages: int | None = 16,
             budget: int | None = None, reps: int = 3,
             spec: HopperSpec | None = None, seed: int = 0,
             device: str | torch.device = "cpu",
             dtype: torch.dtype = torch.float32) -> dict:
    """Full sweep for one geometry: enumerate, prune, benchmark and pick
    the winner per op.  ``shapes`` maps an op to its workload's keywords
    (``b``, ``lq``, ``pages``, ``depths``) in place of ``b``, ``lq`` and
    ``pages``.  The winner is the ``ms`` argmin over the measured set,
    which always holds the default, so ``winner_ms <= default_ms`` holds
    by construction, and the parity gate holds the winner's output to the
    default's."""
    device = torch.device(device)
    if spec is None:
        spec = (HopperSpec.for_device(device) if device.type == "cuda"
                else DEFAULT_HOPPER)
    card = card_line() if device.type == "cuda" else "cpu"
    results = {}
    for op in ops:
        kw = dict(b=b, lq=lq, pages=pages)
        kw.update((shapes or {}).get(op, {}))
        wl = make_workload(op, geom, seed=seed, device=device, dtype=dtype,
                           **kw)
        cands, pruned = prune(wl, budget=budget, spec=spec)
        rows, dropped = benchmark(wl, cands, reps=reps)
        winner = min(rows, key=lambda r: r["ms"])
        results[op] = {
            "key": entry_key(device.type, op, geom),
            "backend": device.type, "op": op, "geometry": geom.key(),
            "workload": wl.describe(), "card": card,
            "candidates": rows,
            "pruned": [{"config": c.as_dict(op), "reason": why}
                       for c, why in pruned],
            "parity_dropped": dropped,
            "winner": winner["config"],
            "winner_ms": winner["ms"],
            "default_ms": rows[0]["ms"],
            "achieved_gbps": winner["achieved_gbps"],
            "op_byte": winner["op_byte"]}
    return results


# --------------------------------------------------------------------------
# tuned-launch cache: persistence + policy-side loading
# --------------------------------------------------------------------------

def resolve_cache_path(path: str | None = None) -> str | None:
    """The cache file to read: ``REPRO_TORCH_TUNED_SHAPES`` overrides
    everything (a path, or one of ``0/off/ignore/none``/empty to disable
    loading: None); otherwise the explicit ``path``; otherwise the
    committed default."""
    env = os.environ.get(ENV_VAR)
    if env is not None:
        if env.strip().lower() in _ENV_OFF:
            return None
        return env
    return path or DEFAULT_CACHE


_load_memo: dict = {}


def load_entries(path: str | None = None) -> dict:
    """The cache's ``entries`` dict, or ``{}`` when loading is disabled,
    the file is missing or corrupt, or the schema is unknown: a broken
    cache must degrade to the default launches, never break serving.
    Memoised by (path, mtime, size), so a policy's load is one stat."""
    p = resolve_cache_path(path)
    if p is None:
        return {}
    try:
        st = os.stat(p)
    except OSError:
        return {}
    key = (p, st.st_mtime_ns, st.st_size)
    if key in _load_memo:
        return _load_memo[key]
    entries: dict = {}
    try:
        with open(p) as f:
            data = json.load(f)
        if isinstance(data, dict) and data.get("schema") == SCHEMA \
                and isinstance(data.get("entries"), dict):
            entries = data["entries"]
    except (OSError, ValueError):
        entries = {}
    _load_memo.clear()
    _load_memo[key] = entries
    return entries


def _round(x: float, digits: int) -> float:
    return round(x, digits) if math.isfinite(x) else x


def save_entries(results: dict, path: str | None = None) -> str:
    """Merge :func:`autotune` results into the cache at ``path`` (default:
    the committed ``tuned_shapes.json`` of this package), atomically.
    Entries for other (device type, op, geometry) keys are kept; an
    unknown on-disk schema is discarded rather than half-merged."""
    path = path or DEFAULT_CACHE
    data: dict = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
    if not isinstance(data, dict) or data.get("schema") not in (None, SCHEMA):
        data = {}
    data["schema"] = SCHEMA
    entries = data.setdefault("entries", {})
    if not isinstance(entries, dict):
        entries = data["entries"] = {}
    for op, r in results.items():
        entries[r["key"]] = {
            "config": r["winner"], "op": op, "geometry": r["geometry"],
            "ms": _round(r["winner_ms"], 6),
            "default_ms": _round(r["default_ms"], 6),
            "achieved_gbps": _round(r["achieved_gbps"], 4),
            "op_byte": _round(r["op_byte"], 4),
            "card": r["card"], "workload": r["workload"]}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path
