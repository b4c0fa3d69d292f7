"""The port on the card: each CUDA kernel against its plain PyTorch
version, the wrappers' refusals, and the serving paths (paged and dense)
through the kernels against the plain path on the CPU and against each
other; the paper's primitives (skinny GEMM, push scatter, the wave
step's volume and flux, vector-sum) through their kernels against float64
oracles or their plain versions, and the wave demo through the volume
kernel against the plain path on the CPU; the grouped expert GEMM and
the MoE model (reduced moonshot) served through it, the bfloat16 init
built in place, the ops that take strided views, and optimistic
admission's preemption on graphed segments (the victim's row latched in
place, graphed against eager), and a mid-flight cancel on graphed
segments (the cancelled row latched in place); the paged kernels at
every launch knob the autotuner sweeps (decode: every split count and
rows a CTA; prefill and verify: every rows a CTA), and serving with the
attention routed plain against the kernels.  Every test here is
marked ``cuda`` and skips without a GPU; on a GPU machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor ``repro``, so it runs where only the
port is installed.  Tolerances: float32 1e-4, bfloat16 2e-2 (max abs
error against the plain version evaluated in float32 on the same values;
TF32 is off).  The primitives' kernels and the grouped expert GEMM (in
both dtypes) sum in float32 in an order of their own (atomics, for push),
so they are held per output to the worst-case
bound of float32 summation, n u / (1 - n u) times the sum of the terms'
magnitudes (u = 2**-24, n the terms summed), against float64 results
from the same, already rounded, inputs."""
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.device import sm_count
from repro_torch.kernels import decode_attn as dattn
from repro_torch.kernels.decode_attn import decode_attn_policy
from repro_torch.kernels import moe_group_gemm as mg
from repro_torch.kernels import push_scatter as ps
from repro_torch.kernels import ss_gemm as sg
from repro_torch.kernels import vector_sum as vs
from repro_torch.kernels import wavesim_flux as wf
from repro_torch.kernels import wavesim_volume as wv
from repro_torch.kernels.paged_attn import (kernel, paged_attn,
                                            paged_attn_ref,
                                            paged_prefill_attn,
                                            paged_prefill_attn_ref, split)
from repro_torch.launch import wave_demo
from repro_torch.launch.serve import run
from repro_torch.models.init import FILL_CHUNK, init_params

torch.set_num_threads(1)

# the condition is a string, so pytest evaluates it when each test runs
pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs a CUDA GPU (the kernels have "
                                        "no CPU mode)")]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GEOMETRIES = [(4, 1, 16, 8),       # reduced qwen2-0.5b
              (14, 2, 64, 16),     # full-width qwen2-0.5b
              (16, 2, 64, 8),      # G = 8, pages of 8
              (16, 16, 128, 16)]   # full-width moonshot (G = 1, D = 128)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True)
def _default_launches():
    """Ops called here outside a batcher launch the kernels' defaults (no
    tuned entry), so the split counts the tests pick are the ones that
    run; a batcher builds its own policy, with the committed entries."""
    with decode_attn_policy(use_tuned=False):
        yield


def _pages(rng, b, hkv, d, n, ps, p_max, depths, dtype):
    """Pools of n live pages plus the sink, a permuted table with
    sentinel tails."""
    def pool():
        a = rng.standard_normal((n + 1, ps, hkv, d)).astype(np.float32)
        return torch.from_numpy(a).to("cuda").to(dtype)
    tbl = np.full((b, p_max), n, np.int32)
    perm = list(rng.permutation(n))
    for i, ln in enumerate(depths):
        for j in range(-(-ln // ps)):
            tbl[i, j] = perm.pop()
    return pool(), pool(), torch.from_numpy(tbl).to("cuda")


# the decode kernels' contract: G 1 to 16, head_dim 16, 64 and 128
DECODE_GEOMETRIES = [(4, 1, 16, 8),       # reduced qwen2-0.5b (G 4)
                     (14, 2, 64, 16),     # full-width qwen2-0.5b (G 7)
                     (16, 2, 64, 8),      # G 8, pages of 8
                     (16, 1, 64, 16),     # G 16
                     (16, 16, 128, 16),   # full-width moonshot (G 1)
                     (16, 1, 128, 16),    # G 16 at D 128
                     (2, 2, 16, 4)]       # G 1 at D 16, pages of 4
DECODE_BOUND = 384                        # keys a table row or cap spans


def _split_batches(splits, hkv, group, bound, lengths):
    """Batches of slot lengths that cover ``lengths``, each of the one
    size (the largest up to len(lengths), or the least that makes it)
    for which the wrappers pick ``splits`` CTAs a slot and row group."""
    sms = sm_count(torch.device("cuda", torch.cuda.current_device()))
    sizes = [b for b in range(1, 600)
             if split.split_count(b, hkv, group, bound, sms) == splits]
    b = max(x for x in sizes if x <= max(len(lengths), sizes[0]))
    return [[lengths[(i + j) % len(lengths)] for j in range(b)]
            for i in range(0, len(lengths), b)]


def _decode_lengths(splits, ps, bound):
    return sorted({0, 1, ps - 1, ps, ps + 1, splits * split.TILE - 1, bound}
                  | set(split.boundary_lengths(splits, bound)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,ps", DECODE_GEOMETRIES)
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_decode_kernel_matches_plain_version(dtype, hq, hkv, d, ps, splits):
    """Lengths 0, 1, page edges, the full table, shorter than ``splits``
    tiles and one key before, at and past every rank boundary, with the
    batch that makes the wrapper pick ``splits`` CTAs a slot and row group
    (G over row groups of ``split.CTA_ROWS``).  The pool
    rows past each slot's length in its last page, every unused page and
    the sink hold NaN, so a read past a length shows; the plain version
    reads the same pools without the NaN."""
    rng = np.random.default_rng(hq + d + splits)
    p_max = DECODE_BOUND // ps
    for lengths in _split_batches(splits, hkv, hq // hkv, DECODE_BOUND,
                                  _decode_lengths(splits, ps, DECODE_BOUND)):
        b = len(lengths)
        n = sum(-(-x // ps) for x in lengths) + 1
        k, v, tbl = _pages(rng, b, hkv, d, n, ps, p_max, lengths, dtype)
        kp, vp = k.clone(), v.clone()
        used = torch.zeros(n + 1, dtype=torch.bool, device="cuda")
        for i, x in enumerate(lengths):
            pages = tbl[i, :-(-x // ps)].long()
            used[pages] = True
            if x % ps:
                kp[pages[-1], x % ps:] = float("nan")
                vp[pages[-1], x % ps:] = float("nan")
        kp[~used] = float("nan")
        vp[~used] = float("nan")
        q = torch.randn(b, hq, d, device="cuda").to(dtype)
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        before = kernel.launch_counts["paged_decode"]
        got = paged_attn(q, kp, vp, tbl, ln)
        assert kernel.launch_counts["paged_decode"] == before + 1
        assert kernel.last_launch["paged_decode"]["splits"] == splits
        want = paged_attn_ref(q.float(), k.float(), v.float(), tbl, ln)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        assert bool(torch.isfinite(got.float()).all())
        assert bool((got[ln == 0] == 0).all())
        assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 8])
def test_decode_kernel_stages_a_wide_table_in_runs(dtype, splits):
    """A table row of 600 pages of 4 keys, wider than the 256 page ids a
    CTA stages at once: a rank's range is walked in runs of 255 pages,
    each staged in turn, at the run edges +-1 and at the full table."""
    rng = np.random.default_rng(splits)
    hq, hkv, d, ps, p_max = 4, 1, 16, 4, 600
    bound = p_max * ps
    lengths = [0, 1, 1019, 1020, 1021, 2039, 2040, 2041, bound - 1, bound]
    for batch in _split_batches(splits, hkv, hq // hkv, bound, lengths):
        n = sum(-(-x // ps) for x in batch)
        k, v, tbl = _pages(rng, len(batch), hkv, d, n, ps, p_max, batch,
                           dtype)
        q = torch.randn(len(batch), hq, d, device="cuda").to(dtype)
        ln = torch.tensor(batch, dtype=torch.int32, device="cuda")
        got = paged_attn(q, k, v, tbl, ln)
        assert kernel.last_launch["paged_decode"]["splits"] == splits
        want = paged_attn_ref(q.float(), k.float(), v.float(), tbl, ln)
        torch.cuda.synchronize()
        assert bool((got[ln == 0] == 0).all())
        assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,ps", GEOMETRIES)
@pytest.mark.parametrize("lq,offsets,cut", [
    (5, [0, 3, 17, 60, 100], [0] * 5),
    (37, [0, 0, 9, 31, 64], [0] * 5),
    (3, [0, 2, 1, 0, 5], [0] * 5),                # kv_len below one tile
    (9, [0, 15, 60, 119, 250], [0] * 5),          # rows across a page and
                                                  # a 64-key tile edge
    (20, [0, 40, 70, 5, 0], [17, 10, 0, 19, 3])])  # kv_len cuts the window
def test_prefill_kernel_matches_plain_version(dtype, hq, hkv, d, ps, lq,
                                              offsets, cut):
    """Prefill and verify shapes, and the tensor-core walk's edges
    (bfloat16; float32 takes the CUDA-core walk): Lq x G not a multiple of
    the 64-row block (at G 7 a block cuts a token's group), queries that
    straddle a page and a 64-key tile, kv_len below one tile, and kv_len
    below some rows' positions."""
    rng = np.random.default_rng(hq + d + lq)
    kv_len = [o + lq - c for o, c in zip(offsets, cut)]
    k, v, tbl = _pages(rng, 5, hkv, d, 100, ps, 40, [o + lq for o in offsets],
                       dtype)
    q = torch.randn(5, lq, hq, d, device="cuda").to(dtype)
    off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    before = kernel.launch_counts["paged_prefill"]
    got = paged_prefill_attn(q, k, v, tbl, off, kvl)
    assert kernel.launch_counts["paged_prefill"] == before + 1
    want = paged_prefill_attn_ref(q.float(), k.float(), v.float(), tbl, off,
                                  kvl)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("hq,hkv,d", [(14, 2, 64), (16, 16, 128)])
def test_prefill_join_at_full_width(hq, hkv, d):
    """A join of eight 512-token prompts in bfloat16 at full-width qwen
    (G 7, D 64) and moonshot (G 1, D 128), pages of 16, against the plain
    version in float32 on the same values."""
    rng = np.random.default_rng(d)
    k, v, tbl = _pages(rng, 8, hkv, d, 256, 16, 32, [512] * 8,
                       torch.bfloat16)
    q = torch.randn(8, 512, hq, d, device="cuda").to(torch.bfloat16)
    off = torch.zeros(8, dtype=torch.int32, device="cuda")
    got = paged_prefill_attn(q, k, v, tbl, off, off + 512)
    want = paged_prefill_attn_ref(q.float(), k.float(), v.float(), tbl, off,
                                  off + 512)
    torch.cuda.synchronize()
    assert (got.float() - want).abs().max().item() <= TOL[torch.bfloat16]


KNOB_GEOMETRIES = [(4, 1, 16, 8),       # reduced qwen2-0.5b (G 4)
                   (14, 2, 64, 16),     # full-width qwen2-0.5b (G 7)
                   (16, 16, 128, 16)]   # full-width moonshot (G 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,ps", KNOB_GEOMETRIES)
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("cta_rows", split.CTA_ROWS_CHOICES)
def test_decode_kernel_at_every_launch_knob(dtype, hq, hkv, d, ps, splits,
                                            cta_rows):
    """Every split count a tuned ``ctas_per_sm`` can give, with every
    ``cta_rows``: lengths 0, 1, page edges, the full table and one key
    before, at and past every rank boundary, the pool rows past each
    length NaN, against the plain version."""
    rng = np.random.default_rng(hq + d + splits + cta_rows)
    p_max = DECODE_BOUND // ps
    lengths = _decode_lengths(splits, ps, DECODE_BOUND)
    b = len(lengths)
    n = sum(-(-x // ps) for x in lengths) + 1
    k, v, tbl = _pages(rng, b, hkv, d, n, ps, p_max, lengths, dtype)
    kp, vp = k.clone(), v.clone()
    for i, x in enumerate(lengths):
        if x % ps:
            page = tbl[i, x // ps].long()
            kp[page, x % ps:] = float("nan")
            vp[page, x % ps:] = float("nan")
    q = torch.randn(b, hq, d, device="cuda").to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = kernel.paged_attn_cuda(q, kp, vp, tbl, ln, cta_rows=cta_rows,
                                 splits=splits)
    assert kernel.last_launch["paged_decode"] == {"splits": splits,
                                                  "cta_rows": cta_rows}
    want = paged_attn_ref(q.float(), k.float(), v.float(), tbl, ln)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    assert bool((got[ln == 0] == 0).all())
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,ps", GEOMETRIES)
@pytest.mark.parametrize("block_rows", kernel.BLOCK_ROWS_CHOICES)
@pytest.mark.parametrize("lq,offsets,cut", [
    (5, [0, 3, 17, 60, 100], [0] * 5),            # a verify: ragged blocks
    (37, [0, 0, 9, 31, 64], [0] * 5),
    (20, [0, 40, 70, 5, 0], [17, 10, 0, 19, 3])])  # kv_len cuts the window
def test_prefill_kernel_at_every_block_rows(dtype, hq, hkv, d, ps,
                                            block_rows, lq, offsets, cut):
    """Both prefill walks at 16, 32 and 64 fused rows a CTA: blocks that
    cut a token's group, a ragged last block, kv_len below some rows'
    positions, against the plain version."""
    rng = np.random.default_rng(hq + d + lq + block_rows)
    kv_len = [o + lq - c for o, c in zip(offsets, cut)]
    k, v, tbl = _pages(rng, 5, hkv, d, 100, ps, 40, [o + lq for o in offsets],
                       dtype)
    q = torch.randn(5, lq, hq, d, device="cuda").to(dtype)
    off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    got = paged_prefill_attn(q, k, v, tbl, off, kvl, block_rows=block_rows)
    assert kernel.last_launch["paged_prefill"] == {"block_rows": block_rows}
    want = paged_prefill_attn_ref(q.float(), k.float(), v.float(), tbl, off,
                                  kvl)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


def test_default_launch_knobs_are_the_old_launches():
    """Without a tuned entry the ops launch two CTAs an SM's split at two
    rows a CTA, and 64 fused rows a prefill CTA: the launches the kernels
    ran before the knobs."""
    rng = np.random.default_rng(7)
    k, v, tbl = _pages(rng, 8, 2, 64, 320, 16, 38, [600] * 8,
                       torch.bfloat16)
    ln = torch.full((8,), 600, dtype=torch.int32, device="cuda")
    q = torch.randn(8, 14, 64, device="cuda").to(torch.bfloat16)
    paged_attn(q, k, v, tbl, ln)
    sms = sm_count(torch.device("cuda", torch.cuda.current_device()))
    assert kernel.last_launch["paged_decode"] == {
        "splits": split.split_count(8, 2, 7, 38 * 16, sms),
        "cta_rows": 2}
    q5 = torch.randn(8, 5, 14, 64, device="cuda").to(torch.bfloat16)
    paged_prefill_attn(q5, k, v, tbl, ln - 5, ln)
    assert kernel.last_launch["paged_prefill"] == {"block_rows": 64}


def test_knob_refusals():
    q = torch.zeros(2, 4, 16, device="cuda")
    pool = torch.zeros(3, 8, 1, 16, device="cuda")
    tbl = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    ln = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="cta_rows"):
        kernel.paged_attn_cuda(q, pool, pool, tbl, ln, cta_rows=3)
    with pytest.raises(ValueError, match="splits"):
        kernel.paged_attn_cuda(q, pool, pool, tbl, ln, splits=3)
    with pytest.raises(ValueError, match="block_rows"):
        kernel.paged_prefill_attn_cuda(q[:, None], pool, pool, tbl, ln - 1,
                                       ln, block_rows=48)


def test_plain_attention_serving_matches_kernels():
    """Reduced qwen2-0.5b, float32, paged and dense: ``attn_mode="plain"``
    (gather, then plain PyTorch attention, on the card) and ``"kernel"``
    give equal greedy streams."""
    params = init_params(get_config("qwen2-0.5b").reduced(), 0,
                         device="cuda")
    for paged in (True, False):
        kw = dict(reduced=True, requests=5, max_new=9, batch=2, max_len=64,
                  paged=paged, page_size=8, sync_every=4,
                  dtype=torch.float32, device="cuda", params=params)
        plain = run("qwen2-0.5b", attn_mode="plain", **kw)
        kern = run("qwen2-0.5b", attn_mode="kernel", **kw)
        assert plain["results"] == kern["results"]
        assert plain["warm_results"] == kern["warm_results"]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(2, 4, 16, device="cuda")
    pool = torch.zeros(3, 8, 1, 16, device="cuda")
    tbl = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    ln = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):                  # pool dtype != q dtype
        kernel.paged_attn_cuda(q, pool.to(torch.bfloat16),
                               pool.to(torch.bfloat16), tbl, ln)
    with pytest.raises(TypeError):                  # int64 table
        kernel.paged_attn_cuda(q, pool, pool, tbl.long(), ln)
    with pytest.raises(ValueError):                 # not contiguous
        kernel.paged_attn_cuda(torch.zeros(4, 2, 16, device="cuda")
                               .transpose(0, 1), pool, pool, tbl, ln)
    with pytest.raises(ValueError, match="aligned"):  # q off 16 bytes
        kernel.paged_attn_cuda(torch.zeros(129, device="cuda")[1:]
                               .view(2, 4, 16), pool, pool, tbl, ln)


def test_serving_through_kernels_matches_cpu_plain_path():
    """Reduced qwen2-0.5b, float32, same weights: the batcher on the card
    (kernels) and on the CPU (plain versions) give equal greedy tokens."""
    params = init_params(get_config("qwen2-0.5b").reduced(), 0,
                         device="cuda")
    kw = dict(reduced=True, requests=5, max_new=9, batch=2, max_len=64,
              paged=True, page_size=8, sync_every=4, dtype=torch.float32)
    kernel.reset_launch_counts()
    on_card = run("qwen2-0.5b", device="cuda", params=params, **kw)
    assert min(kernel.launch_counts.values()) > 0
    on_cpu = run("qwen2-0.5b", device="cpu", params=_to_cpu(params), **kw)
    assert on_card["results"] == on_cpu["results"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,ps", DECODE_GEOMETRIES)
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("s_cap", [None, 200])
def test_decode_attn_kernel_matches_plain_version(dtype, hq, hkv, d, ps,
                                                  splits, s_cap):
    """Lengths 0 (zeros), 1, shorter than ``splits`` tiles, one key
    before, at and past every rank boundary, and above the rows read, with
    the batch that makes the wrapper pick ``splits`` CTAs a slot and row
    group; with ``s_cap`` the rows past it hold NaN and must never be
    read."""
    rng = np.random.default_rng(hq + d + splits)
    s = DECODE_BOUND
    cap = s if s_cap is None else s_cap
    lengths = _decode_lengths(splits, ps, cap) + [cap + 5]
    for chunk in _split_batches(splits, hkv, hq // hkv, cap, lengths):
        b = len(chunk)

        def stripe():
            a = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            a[:, cap:] = np.nan
            return torch.from_numpy(a).to("cuda").to(dtype)
        k, v = stripe(), stripe()
        q = torch.randn(b, hq, d, device="cuda").to(dtype)
        ln = torch.tensor(chunk, dtype=torch.int32, device="cuda")
        before = dattn.launch_counts["decode_attn"]
        got = dattn.decode_attn(q, k, v, ln, s_cap=s_cap)
        assert dattn.launch_counts["decode_attn"] == before + 1
        assert dattn.kernel.last_splits["decode_attn"] == splits
        want = dattn.decode_attn_ref(q.float(), k[:, :cap].float(),
                                     v[:, :cap].float(), ln)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        assert bool(torch.isfinite(got.float()).all())
        assert bool((got[ln == 0] == 0).all())
        assert (got.float() - want).abs().max().item() <= TOL[dtype]


def test_decode_attn_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(2, 4, 16, device="cuda")
    kv = torch.zeros(2, 8, 1, 16, device="cuda")
    ln = torch.ones(2, dtype=torch.int32, device="cuda")
    run_ = dattn.kernel.decode_attn_cuda
    with pytest.raises(TypeError):                  # stripe dtype != q dtype
        run_(q, kv.to(torch.bfloat16), kv.to(torch.bfloat16), ln, 8)
    with pytest.raises(TypeError):                  # int64 lengths
        run_(q, kv, kv, ln.long(), 8)
    with pytest.raises(ValueError):                 # not contiguous
        run_(q, torch.zeros(2, 16, 1, 16, device="cuda")[:, ::2], kv, ln, 8)
    with pytest.raises(ValueError):                 # s_cap past the stripe
        run_(q, kv, kv, ln, 9)
    with pytest.raises(ValueError):                 # head_dim 32
        run_(torch.zeros(2, 4, 32, device="cuda"),
             torch.zeros(2, 8, 1, 32, device="cuda"),
             torch.zeros(2, 8, 1, 32, device="cuda"), ln, 8)
    with pytest.raises(ValueError):                 # G = 17
        run_(torch.zeros(2, 17, 16, device="cuda"), kv, kv, ln, 8)
    with pytest.raises(ValueError, match="aligned"):  # q off 16 bytes
        run_(torch.zeros(129, device="cuda")[1:].view(2, 4, 16), kv, kv, ln,
             8)


def _dense_run(params, device, **kw):
    kw = dict(dict(reduced=True, requests=5, max_new=9, batch=2, max_len=64,
                   sync_every=4, dtype=torch.float32), **kw)
    return run("qwen2-0.5b", device=device, params=params, **kw)["results"]


def test_dense_serving_through_kernel_matches_cpu_plain_path():
    """Reduced qwen2-0.5b, float32, same weights: the dense batcher on the
    card (decode kernel, one launch per layer and step) and on the CPU
    (plain version) give equal greedy tokens, and so does the paged
    batcher on the card."""
    params = init_params(get_config("qwen2-0.5b").reduced(), 0,
                         device="cuda")
    dattn.reset_launch_counts()
    kernel.reset_launch_counts()
    on_card = _dense_run(params, "cuda")
    assert dattn.launch_counts["decode_attn"] > 0
    assert kernel.launch_counts == {"paged_decode": 0, "paged_prefill": 0}
    assert on_card == _dense_run(_to_cpu(params), "cpu")
    assert on_card == _dense_run(params, "cuda", paged=True, page_size=8)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


# ---------------------------------------------------------------------------
# the paper's primitives: skinny GEMM (masked, compact) and push scatter
# ---------------------------------------------------------------------------

def _gamma(n_terms):
    """Worst-case relative bound of a float32 sum of ``n_terms`` terms in
    any order, each term rounded at most once: n u / (1 - n u), u = 2**-24
    (the first-order n u for n u << 1)."""
    nu = n_terms * 2.0 ** -24
    return nu / (1 - nu)


def _within_bound(got, want64, abs64, n_terms):
    """|got - want| <= gamma(n) x sum |terms|, per output; the float64
    results come from the kernel's own (already rounded) inputs."""
    err = (got.double() - want64).abs()
    return bool((err <= _gamma(n_terms) * abs64).all())


def _skinny(rng, m, k, n, density, dtype, bk):
    """A [M, K] and B [K, N] on the card, B's k-blocks of bk rows dead with
    probability 1 - density (at density 0.05 one block is kept live)."""
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = rng.standard_normal((k, n)).astype(np.float32)
    nk = -(-k // bk)
    live = rng.random(nk) < density
    if 0 < density < 1 and not live.any():
        live[nk // 2] = True
    b[~np.repeat(live, bk)[:k]] = 0.0
    return (a.to("cuda").to(dtype),
            torch.from_numpy(b).to("cuda").to(dtype))


SKINNY_SHAPES = [(256, 1024, 128),   # aligned
                 (300, 300, 128),    # ragged M and K (K % 8 != 0 in bf16)
                 (77, 520, 256),     # ragged M, K % 8 == 0, ragged last block
                 (300, 4096, 256),   # ragged M, the paper's K
                 (1000, 1024, 128)]  # M a multiple of no CTA's rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 9, 15, 16])
@pytest.mark.parametrize("m,k,bk", SKINNY_SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
def test_ssgemm_kernels_match_plain_version(dtype, n, m, k, bk, density):
    """Both walks against their plain versions in float64 on the same
    values, within the worst-case float32 summation bound, on the route
    ``kernel.route`` picks (the tensor-core walk for bfloat16 with K % 8 ==
    0 and bk % 16 == 0, padding N to 8 or 16; the CUDA-core walk for the
    rest), as ``route_counts`` shows; the compact op at budgets 1, the live
    count and every block (the first takes the overflow guard whenever two
    or more blocks are live)."""
    rng = np.random.default_rng(m + n + int(100 * density))
    a, b = _skinny(rng, m, k, n, density, dtype, bk)
    a64, b64 = a.double(), b.double()
    mask = sg.block_occupancy(b, bk)
    path = ("tensor_core" if dtype == torch.bfloat16 and k % 8 == 0
            and bk % 16 == 0 else "cuda_core")
    assert sg.route(a, b, bk) == path
    before, routes = dict(sg.launch_counts), dict(sg.route_counts)
    got = sg.kernel.ssgemm_masked_cuda(a, b, mask, bk)
    assert sg.launch_counts["ssgemm_masked"] == before["ssgemm_masked"] + 1
    assert sg.route_counts[path] == routes[path] + 1
    want = sg.ssgemm_masked_ref(a64, b64, mask, bk)
    bnd = sg.ssgemm_masked_ref(a64.abs(), b64.abs(), mask, bk)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _within_bound(got, want, bnd, k)
    full, full_abs = a64 @ b64, a64.abs() @ b64.abs()
    assert _within_bound(sg.ssgemm_masked(a, b, bk=bk), full, full_abs, k)
    nk = mask.shape[0]
    n_live = int(mask.sum())
    for budget in sorted({1, max(n_live, 1), nk}):
        got = sg.ssgemm_compact(a, b, budget=budget, bk=bk)
        assert _within_bound(got, full, full_abs, k), budget
    # the list walk on its own arguments: every other block, out of order
    idx = torch.arange(nk - 1, -1, -2, dtype=torch.int32, device="cuda")
    nl = torch.tensor([max(idx.numel() - 1, 0)], dtype=torch.int32,
                      device="cuda")
    got = sg.kernel.ssgemm_compact_cuda(a, b, idx, nl, bk)
    want = sg.ssgemm_compact_ref(a64, b64, idx, nl, bk)
    bnd = sg.ssgemm_compact_ref(a64.abs(), b64.abs(), idx, nl, bk)
    torch.cuda.synchronize()
    assert _within_bound(got, want, bnd, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("m,k,bk", [(1000, 4096, 256), (77, 520, 256),
                                    (300, 1024, 64)])
def test_ssgemm_skipped_blocks_are_not_read(dtype, n, m, k, bk):
    """A's columns in every block the walk skips hold NaN (for the list
    walk also the live blocks listed past n_live): a kernel that loaded
    them and multiplied by B's zeros would return NaN.  The kernels and
    the ops stay finite and within the float32 bound."""
    rng = np.random.default_rng(m + n)
    a, b = _skinny(rng, m, k, n, 1.0, dtype, bk)
    nk = -(-k // bk)
    for kb in range(1, nk, 2):       # the odd blocks dead, the last live
        if kb < nk - 1:
            b[kb * bk:(kb + 1) * bk] = 0
    mask = sg.block_occupancy(b, bk)
    live = torch.nonzero(mask).reshape(-1)
    assert 2 <= live.numel() < nk
    a64, b64 = a.double(), b.double()
    want, bnd = a64 @ b64, a64.abs() @ b64.abs()

    def poisoned(walked):
        cols = torch.zeros(k, dtype=torch.bool, device="cuda")
        for kb in walked:
            cols[kb * bk:(kb + 1) * bk] = True
        return a.masked_fill(~cols, float("nan"))

    a_masked = poisoned(live.tolist())
    got = [sg.kernel.ssgemm_masked_cuda(a_masked, b, mask, bk),
           sg.ssgemm_masked(a_masked, b, bk=bk),
           sg.ssgemm_compact(a_masked, b, budget=live.numel(), bk=bk)]
    for out in got:
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert _within_bound(out, want, bnd, k)
    # the list walk: the live blocks in reverse, the last one past n_live
    idx = live.flip(0).to(torch.int32)
    nl = torch.tensor([idx.numel() - 1], dtype=torch.int32, device="cuda")
    a_list = poisoned(idx[:-1].tolist())
    out = sg.kernel.ssgemm_compact_cuda(a_list, b, idx, nl, bk)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _within_bound(out, sg.ssgemm_compact_ref(a64, b64, idx, nl, bk),
                         sg.ssgemm_compact_ref(a64.abs(), b64.abs(), idx, nl,
                                               bk), k)


def test_ssgemm_odd_width_and_dense_entry_point():
    """N = 3 and N = 13 (the kernel rounds the width up internally) and
    the dense entry point, against float64."""
    rng = np.random.default_rng(5)
    for n in (1, 3, 13):
        a, b = _skinny(rng, 130, 512, n, 0.5, torch.bfloat16, 128)
        a64, b64 = a.double(), b.double()
        want, bnd = a64 @ b64, a64.abs() @ b64.abs()
        for fn in (sg.ssgemm_masked, lambda a, b: sg.ssgemm(
                a, b, sparsity_aware=False)):
            got = fn(a, b)
            assert got.shape == (130, n)
            assert _within_bound(got, want, bnd, 512)


def test_ssgemm_wrappers_refuse_what_the_kernels_do_not_take():
    a = torch.zeros(64, 256, device="cuda")
    b = torch.zeros(256, 4, device="cuda")
    mask = torch.ones(2, dtype=torch.int32, device="cuda")
    run_ = sg.kernel.ssgemm_masked_cuda
    with pytest.raises(TypeError):                  # float16
        run_(a.half(), b.half(), mask, 128)
    with pytest.raises(TypeError):                  # b dtype != a dtype
        run_(a, b.to(torch.bfloat16), mask, 128)
    with pytest.raises(ValueError):                 # a on the CPU
        run_(a.cpu(), b, mask, 128)
    with pytest.raises(ValueError):                 # N = 17
        run_(a, torch.zeros(256, 17, device="cuda"), mask, 128)
    with pytest.raises(ValueError):                 # not contiguous
        run_(torch.zeros(256, 64, device="cuda").t(), b, mask, 128)
    with pytest.raises(ValueError):                 # mask of the wrong size
        run_(a, b, mask, 64)
    with pytest.raises(TypeError):                  # int64 list
        sg.kernel.ssgemm_compact_cuda(a, b, mask.long(), mask[:1], 128)
    with pytest.raises(ValueError):                 # budget past the blocks
        sg.ssgemm_compact(a, b, budget=3, bk=128)
    with pytest.raises(ValueError):                 # N = 17 through the op
        sg.ssgemm_masked(a, torch.ones(256, 17, device="cuda"))


@pytest.mark.parametrize("n,u,hot,kind", [
    (5000, 3000, 256, "zipf"),
    (512, 2048, 512, "zipf"),       # hot == n < 1024
    (200_000, 100_003, 1024, "zipf"),  # U not a multiple of any tile
    (4096, 4096, 1024, "cold"),     # every destination once, hot set empty
    (256, 10_000, 256, "hot"),      # every update hot
])
def test_push_scatter_kernel_matches_plain_version(n, u, hot, kind):
    """The kernel against its plain version: the cold values exactly, each
    hot slot within the float32 summation bound of its own update count;
    and the op against the float64 oracle."""
    rng = np.random.default_rng(n + u)
    if kind == "zipf":
        pop = 1.0 / np.arange(1, n + 1) ** 1.1
        dst = rng.choice(n, size=u, p=pop / pop.sum())
    elif kind == "cold":
        dst = rng.permutation(n)[:u]
    else:
        dst = rng.integers(0, n, size=u)
    dst = torch.from_numpy(dst.astype(np.int64)).to("cuda")
    contrib = torch.from_numpy(rng.standard_normal(u).astype(np.float32))
    contrib = contrib.to("cuda")
    values = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    values = values.to("cuda")
    slots = ps.hot_set(dst, n, hot)[dst]
    if kind == "cold":                              # no update has a slot
        slots = torch.full_like(slots, -1)
    before = ps.launch_counts["push_scatter"]
    hot_acc, cold = ps.kernel.push_scatter_cuda(slots, contrib, hot)
    assert ps.launch_counts["push_scatter"] == before + 1
    want_acc, want_cold = ps.push_scatter_kernel_ref(slots, contrib.double(),
                                                     hot)
    abs_acc, _ = ps.push_scatter_kernel_ref(slots,
                                            contrib.abs().double(), hot)
    count, _ = ps.push_scatter_kernel_ref(slots, torch.ones_like(contrib),
                                          hot)
    torch.cuda.synchronize()
    assert torch.equal(cold.double(), want_cold)
    err = (hot_acc.double() - want_acc).abs()
    assert bool((err <= _gamma(count.double()) * abs_acc).all())
    if kind == "hot":
        assert bool((cold == 0).all())
    if kind == "cold":
        assert bool((hot_acc == 0).all())
    got = ps.push_scatter(values, contrib, dst, hot=hot)
    want = ps.push_scatter_ref(values.double(), contrib.double(), dst)
    bnd = ps.push_scatter_ref(values.double().abs(), contrib.double().abs(),
                              dst)
    terms = 1 + torch.bincount(dst, minlength=n).double()
    assert bool(((got.double() - want).abs() <= _gamma(terms) * bnd).all())


def test_push_scatter_wrapper_refuses_what_the_kernel_does_not_take():
    s = torch.zeros(8, dtype=torch.int32, device="cuda")
    v = torch.zeros(8, device="cuda")
    run_ = ps.kernel.push_scatter_cuda
    with pytest.raises(TypeError):                  # int64 slots
        run_(s.long(), v, 4)
    with pytest.raises(TypeError):                  # bfloat16 values
        run_(s, v.to(torch.bfloat16), 4)
    with pytest.raises(ValueError):                 # values on the CPU
        run_(s, v.cpu(), 4)
    with pytest.raises(ValueError):                 # not contiguous
        run_(s, torch.zeros(16, device="cuda")[::2], 4)
    with pytest.raises(ValueError):                 # hot set past smem
        run_(s, v, ps.kernel.MAX_HOT + 1)
    with pytest.raises(ValueError):                 # hot set empty
        run_(s, v, 0)


# ---------------------------------------------------------------------------
# the wave step's kernels and vector-sum
# ---------------------------------------------------------------------------

_MANTISSA = {torch.float32: 24, torch.bfloat16: 8}


def _ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype``'s values at |x| (normal range)."""
    m = x.double().abs().clamp_min(torch.finfo(dtype).tiny)
    return torch.exp2(torch.floor(torch.log2(m)) - (_MANTISSA[dtype] - 1))


def _volume_within(got, x64, w64, dtype, n_terms=27) -> bool:
    """Per output, |got - want| <= gamma(n_terms) x sum |x_i w_ij| (27 for
    any summation of a row, 7 for the stencil's chains), plus, for a
    bfloat16 output, its own rounding (2**-8 |got|), with want and the sum
    of magnitudes in float64 from the same x and the same rounded W."""
    want = wv.volume_kernel_ref(x64, w64)
    mag = wv.volume_kernel_ref(x64.abs(), w64.abs())
    lim = _gamma(n_terms) * mag
    if dtype != torch.float32:
        lim = lim + 2.0 ** -8 * got.double().abs()
    return bool(((got.double() - want).abs() <= lim).all())


def _lines_agree(got: list[str], want: list[str]) -> bool:
    """The same energy lines to their printed precision: the same steps,
    each number within one unit of its last printed place (float32 sums
    taken in another order may round the last digit the other way)."""
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


VOLUME_SHAPES = [(1, 1), (8, 9), (65, 27), (256, 3), (64000, 27)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,f", VOLUME_SHAPES)
@pytest.mark.parametrize("c", [1.0, 0.7])
def test_volume_kernel_matches_plain_version(dtype, e, f, c):
    """The op on the card against the kernel's plain version in float64
    from the same inputs and the same rounded W, within the float32 bound
    of a 27-term sum; ragged last tiles included (E*F of 1, 72, 1,755,
    768 and 1,728,000 rows)."""
    gen = torch.Generator(device="cuda").manual_seed(e + f)
    u = torch.randn(e, f, 3, 3, 3, generator=gen, device="cuda").to(dtype)
    w = wv.fused_operator(c, dtype)
    before = wv.launch_counts["wavesim_volume"]
    got = wv.volume(u, c)
    assert wv.launch_counts["wavesim_volume"] == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == u.shape
    assert _volume_within(got.reshape(-1, 27), u.reshape(-1, 27).double(),
                          w.double(), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_volume_kernel_unaligned_rows(dtype):
    """Rows that start one element past a 16-byte boundary take the
    kernel's scalar loads and stores."""
    rows = 700
    buf = torch.randn(rows * 27 + 1, device="cuda").to(dtype)
    x = buf[1:].view(rows, 27)
    w, stencil = wv.ops.operator(0.7, dtype)
    got = wv.kernel.volume_cuda(x, stencil)
    torch.cuda.synchronize()
    assert _volume_within(got, x.double(), w.double(), dtype)


def test_volume_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(64, 27, device="cuda")
    w = wv.fused_operator()
    s = wv.stencil_operator(w)
    run_ = wv.kernel.volume_cuda
    with pytest.raises(ValueError):                 # x on the CPU
        run_(x.cpu(), s)
    with pytest.raises(TypeError):                  # float16
        run_(x.half(), s)
    with pytest.raises(TypeError):                  # stencil not float32
        run_(x, s.to(torch.bfloat16))
    with pytest.raises(ValueError):                 # stencil on the card
        run_(x, s.cuda())
    with pytest.raises(ValueError):                 # not contiguous
        run_(torch.zeros(27, 64, device="cuda").t(), s)
    with pytest.raises(ValueError):                 # rows padded to 32
        run_(torch.zeros(64, 32, device="cuda"), s)
    with pytest.raises(ValueError):                 # W, not its stencil
        run_(x, w)
    with pytest.raises(ValueError):                 # not [E, F, 3, 3, 3]
        wv.volume(torch.zeros(4, 3, 27, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,f", VOLUME_SHAPES)
@pytest.mark.parametrize("c", [1.0, 0.7])
def test_volume_kernel_within_the_stencil_bound(dtype, e, f, c):
    """Each output is a chain of its 7 stencil terms, so the kernel holds
    to gamma(7) x sum |terms| against float64, not only gamma(27)."""
    gen = torch.Generator(device="cuda").manual_seed(3 * e + f)
    u = torch.randn(e, f, 3, 3, 3, generator=gen, device="cuda").to(dtype)
    w = wv.fused_operator(c, dtype)
    got = wv.volume(u, c)
    torch.cuda.synchronize()
    assert _volume_within(got.reshape(-1, 27), u.reshape(-1, 27).double(),
                          w.double(), dtype, n_terms=7)


def _walk_rows(which: int) -> int:
    """Row counts that end a persistent CTA's walk anywhere in its ring:
    1, a tile less or more one row, a tile for every CTA of the grid less,
    at and more one row, and a walk that wraps the ring."""
    sms = sm_count(torch.device("cuda", torch.cuda.current_device()))
    grid = wv.kernel.CTAS_PER_SM * sms * wv.kernel.TILE_ROWS
    return [1, 255, 257, grid - 1, grid, grid + 1,
            4 * grid + 3 * wv.kernel.TILE_ROWS + 5][which]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", range(7))
@pytest.mark.parametrize("offset", [0, 1])
def test_volume_kernel_walk_ends(dtype, which, offset):
    """The walk over row counts that stop it mid-ring, on an aligned base
    (bulk copies; a ragged last tile on the plain path) and one element
    past it (every tile on the plain path): within gamma(27) and
    gamma(7)."""
    rows = _walk_rows(which)
    gen = torch.Generator(device="cuda").manual_seed(rows + offset)
    buf = torch.randn(rows * 27 + 1, generator=gen, device="cuda").to(dtype)
    x = buf[offset:offset + rows * 27].view(rows, 27)
    w, stencil = wv.ops.operator(0.7, dtype)
    before = wv.launch_counts["wavesim_volume"]
    got = wv.kernel.volume_cuda(x, stencil)
    assert wv.launch_counts["wavesim_volume"] == before + 1
    torch.cuda.synchronize()
    for n_terms in (27, 7):
        assert _volume_within(got, x.double(), w.double(), dtype, n_terms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_volume_wrapper_refuses_an_off_pattern_w(dtype):
    """A W with a nonzero (or NaN) entry off the 7-point pattern has no
    stencil, the wrapper takes no W, and a stencil that is not 189
    float32 values on the CPU is refused: all before any launch."""
    x = torch.zeros(64, 27, device="cuda").to(dtype)
    before = wv.launch_counts["wavesim_volume"]
    for bad in (0.5, float("nan")):
        w = wv.fused_operator(1.0, dtype).clone()
        w[0, 26] = bad
        with pytest.raises(ValueError):
            wv.stencil_operator(w)
        with pytest.raises(ValueError):
            wv.kernel.volume_cuda(x, w)
    s = wv.ops.operator(1.0, dtype)[1]
    for wrong in (s[:188], s.cuda()):
        with pytest.raises(ValueError):
            wv.kernel.volume_cuda(x, wrong)
    with pytest.raises(TypeError):
        wv.kernel.volume_cuda(x, s.double())
    assert wv.launch_counts["wavesim_volume"] == before


FLUX_SHAPES = [(1, 9), (4, 9), (600, 27), (1024, 128), (64000, 243)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,t", FLUX_SHAPES)
@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_flux1d_kernel_matches_plain_version(dtype, e, t, alpha):
    """Equal to the plain version (``torch.roll``) on the card at alpha
    0.5; within one ulp of the dtype at 0.3, where the plain version
    rounds twice in bfloat16 and the kernel once."""
    gen = torch.Generator(device="cuda").manual_seed(e + t)
    hi = torch.randn(e, t, generator=gen, device="cuda").to(dtype)
    lo = torch.randn(e, t, generator=gen, device="cuda").to(dtype)
    before = wf.launch_counts["flux1d"]
    got = wf.flux1d(hi, lo, alpha)
    assert wf.launch_counts["flux1d"] == before + 1
    want = wf.flux1d_ref(hi, lo, alpha)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert g.dtype == dtype and g.shape == (e, t)
        if alpha == 0.5:
            assert torch.equal(g, w_)
        else:
            err = (g.double() - w_.double()).abs()
            lim = _ulp(torch.maximum(g.double().abs(), w_.double().abs()),
                       dtype)
            assert bool((err <= lim).all())


def test_flux1d_wrapper_refuses_what_the_kernel_does_not_take():
    hi = torch.zeros(8, 9, device="cuda")
    run_ = wf.kernel.flux1d_cuda
    with pytest.raises(ValueError):                 # on the CPU
        run_(hi.cpu(), hi.cpu())
    with pytest.raises(TypeError):                  # float16
        run_(hi.half(), hi.half())
    with pytest.raises(TypeError):                  # lo in another dtype
        run_(hi, hi.to(torch.bfloat16))
    with pytest.raises(ValueError):                 # not contiguous
        run_(torch.zeros(9, 8, device="cuda").t(), hi)
    with pytest.raises(ValueError):                 # shapes differ
        run_(hi, torch.zeros(8, 8, device="cuda"))
    with pytest.raises(ValueError):                 # not [E, T]
        run_(hi[None], hi[None])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(0,), (1,), (7,), (512,), (10_000,),
                                   (64 << 20,), (3, 5, 7)])
def test_vector_sum_kernel_matches_plain_version(dtype, shape):
    """Exactly a + b in every dtype, from the empty input (no launch) to
    the paper's 64 Mi elements."""
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    a = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    b = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    before = vs.launch_counts["vector_sum"]
    got = vs.vector_sum(a, b)
    assert vs.launch_counts["vector_sum"] == before + (a.numel() > 0)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == a.shape
    assert torch.equal(got, vs.vector_sum_ref(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_vector_sum_kernel_unaligned(dtype):
    """Inputs one element past a 16-byte boundary (the scalar path)."""
    buf = torch.randn(2, 10_001, device="cuda").to(dtype)
    a, b = buf[0, 1:], buf[1, 1:]
    got = vs.kernel.vector_sum_cuda(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, a + b)


def _span_length(dtype: torch.dtype, which: int) -> int:
    """Lengths at which the kernel's spans change shape, less one, as is
    and plus one: one row of 16-byte chunks, one span of UNROLL rows, a
    span and a row, five spans, and five spans and a row."""
    row = vs.kernel.THREADS * (16 // dtype.itemsize)
    unroll = vs.kernel.UNROLL
    spans = (1, unroll, unroll + 1, 5 * unroll, 5 * unroll + 1)
    return spans[which // 3] * row + which % 3 - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("which", range(15))
def test_vector_sum_kernel_at_span_boundaries(dtype, which):
    """Exactly a + b where the length ends on, one element before or one
    element past a row, a span, or a span and a row (the last CTA's
    ragged span and its scalar tail)."""
    n = _span_length(dtype, which)
    gen = torch.Generator(device="cuda").manual_seed(n)
    a = torch.randn(n, generator=gen, device="cuda").to(dtype)
    b = torch.randn(n, generator=gen, device="cuda").to(dtype)
    got = vs.kernel.vector_sum_cuda(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, vs.vector_sum_ref(a, b))


def test_vector_sum_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.zeros(16, device="cuda")
    run_ = vs.kernel.vector_sum_cuda
    with pytest.raises(ValueError):                 # on the CPU
        run_(a.cpu(), a.cpu())
    with pytest.raises(TypeError):                  # int32
        run_(a.int(), a.int())
    with pytest.raises(TypeError):                  # b in another dtype
        run_(a, a.half())
    with pytest.raises(ValueError):                 # not contiguous
        run_(a[::2], a[::2])
    with pytest.raises(ValueError):                 # shapes differ
        run_(a, a[:8])
    with pytest.raises(ValueError):                 # through the op
        vs.vector_sum(a, a[:8])


def test_wave_demo_through_kernel_matches_cpu_plain_path():
    """The demo's 40 steps with the volume kernel on the card against the
    plain path on the CPU: u within 1e-5, the same energy lines to their
    printed precision, one launch a step."""
    before = wv.launch_counts["wavesim_volume"]
    on_card = wave_demo.run(device="cuda", verbose=False)
    assert wv.launch_counts["wavesim_volume"] == before + 40
    on_cpu = wave_demo.run(device="cpu", verbose=False)
    err = (on_card["u"].cpu() - on_cpu["u"]).abs().max().item()
    assert err <= 1e-5
    assert _lines_agree(on_card["energy"], on_cpu["energy"])


# ---------------------------------------------------------------------------
# the grouped expert GEMM and the MoE model
# ---------------------------------------------------------------------------

GROUP_SHAPES = [(2, 128, 64, 64, None),     # test_kernels_moe.py's sweep
                (8, 256, 128, 96, None),
                (4, 64, 32, 256, None),
                (64, 1, 2048, 1408, None),  # moonshot decode, C 1
                (6, 100, 48, 80, None),     # ragged C and F
                (4, 64, 32, 64, "all-empty"),
                (4, 64, 32, 64, "all-full"),
                (3, 300, 200, 136, None),   # C, K and F past whole tiles
                (64, 480, 2048, 1408, "routed"),  # moonshot's join: gate/up
                (64, 480, 1408, 2048, "routed")]  # and down


def _routed_counts(tokens):
    """Expert counts of one MoE call over ``tokens`` tokens at full-width
    moonshot: the port's route and rank dispatch on a seeded router
    (N(0, 0.02)) and seeded activations of unit RMS."""
    from repro_torch.models import moe
    cfg = get_config("moonshot-v1-16b-a3b")
    gen = torch.Generator(device="cuda").manual_seed(tokens)
    router = {"w": 0.02 * torch.randn(cfg.d_model, cfg.moe.n_experts,
                                      generator=gen, device="cuda")}
    x = torch.randn(tokens, cfg.d_model, generator=gen, device="cuda")
    _, ids, _ = moe.route({"router": router}, x, cfg)
    return moe.dispatch(ids, cfg.moe.n_experts,
                        moe.capacity(cfg, tokens))[2].cpu().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f,fill", GROUP_SHAPES)
def test_group_gemm_kernel_matches_plain_version(dtype, e, c, d, f, fill):
    """One launch through the op; the rows below each count within the
    float32 summation bound of the float64 product of the same values (in
    bfloat16 too: the products are exact and summed in float32); the rows
    past it exactly zero, although the padding rows of xe and the weights
    of the empty experts hold NaN, which a skipped tile never reads.  A
    second launch through the wrapper gives the same bits and counts on
    the card the tiles the counts leave empty."""
    rng = np.random.default_rng(e * c + d)
    if fill == "routed":                # a 4,096-token join: C 480
        counts = _routed_counts(4096).astype(np.int32)
        assert counts.shape == (e,) and counts.max() <= c
    else:
        counts = {"all-empty": np.zeros(e), "all-full": np.full(e, c)}.get(
            fill, rng.integers(0, c + 1, size=e)).astype(np.int32)
        counts[0] = 0 if fill is None else counts[0]
    xe = torch.from_numpy(rng.standard_normal((e, c, d)).astype(
        np.float32)).to("cuda").to(dtype)
    w = torch.from_numpy(rng.standard_normal((e, d, f)).astype(
        np.float32)).to("cuda").to(dtype)
    cnt = torch.from_numpy(counts).to("cuda")
    live = (torch.arange(c, device="cuda")[None, :, None]
            < cnt[:, None, None])
    x64, w64 = (xe * live).double(), w.double()
    want, bnd = x64 @ w64, x64.abs() @ w64.abs()
    xe = torch.where(live, xe, torch.full_like(xe, float("nan")))
    w[cnt == 0] = float("nan")
    before = mg.launch_counts["group_gemm"]
    got = mg.group_gemm(xe, w, cnt)
    assert mg.launch_counts["group_gemm"] == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (e, c, f)
    assert bool((got[~live.expand(e, c, f)] == 0).all())
    assert _within_bound(got, want, bnd, d)
    tiles = torch.zeros(2, dtype=torch.int32, device="cuda")
    assert torch.equal(mg.kernel.group_gemm_cuda(xe, w, cnt, tiles=tiles),
                       got)
    total, skipped = mg.kernel.tile_counts(cnt, c, f, dtype)
    assert tiles.tolist() == [total, skipped]
    bm = mg.kernel.tile_rows(c, dtype)
    n_f = -(-f // mg.kernel.tile_cols(c, dtype))
    assert total == e * -(-c // bm) * n_f
    assert skipped == n_f * sum(-(-c // bm) - -(-int(n) // bm)
                                for n in counts)


def test_group_gemm_wrapper_refuses_what_the_kernel_does_not_take():
    xe = torch.zeros(2, 4, 8, device="cuda")
    w = torch.zeros(2, 8, 16, device="cuda")
    cnt = torch.ones(2, dtype=torch.int32, device="cuda")
    run_ = mg.kernel.group_gemm_cuda
    with pytest.raises(ValueError):                 # on the CPU
        run_(xe.cpu(), w.cpu(), cnt.cpu())
    with pytest.raises(TypeError):                  # float16
        run_(xe.half(), w.half(), cnt)
    with pytest.raises(TypeError):                  # w in another dtype
        run_(xe, w.to(torch.bfloat16), cnt)
    with pytest.raises(TypeError):                  # int64 counts
        run_(xe, w, cnt.long())
    with pytest.raises(ValueError):                 # not contiguous
        run_(xe, torch.zeros(2, 16, 8, device="cuda").transpose(1, 2), cnt)
    with pytest.raises(ValueError):                 # D does not chain
        run_(xe, torch.zeros(2, 9, 16, device="cuda"), cnt)
    with pytest.raises(ValueError):                 # counts for 3 experts
        run_(xe, w, torch.ones(3, dtype=torch.int32, device="cuda"))
    cnt3 = torch.zeros(3, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16 bytes"):   # D 37, F 53 rows
        run_(torch.zeros(3, 40, 37, device="cuda"),
             torch.zeros(3, 37, 53, device="cuda"), cnt3)
    with pytest.raises(ValueError, match="16 bytes"):   # bf16 D 4
        run_(xe.to(torch.bfloat16)[:, :, :4].contiguous(),
             torch.zeros(2, 4, 16, dtype=torch.bfloat16, device="cuda"), cnt)
    flat = torch.zeros(1 + 2 * 4 * 8, device="cuda")
    with pytest.raises(ValueError, match="16-byte boundaries"):
        run_(flat[1:].view(2, 4, 8), w, cnt)        # one float past
    with pytest.raises(ValueError, match="16 bytes"):   # through the op
        mg.group_gemm(torch.zeros(3, 40, 37, device="cuda"),
                      torch.zeros(3, 37, 53, device="cuda"), cnt3)
    with pytest.raises(ValueError):                 # tiles not int32 [2]
        run_(xe, w, cnt, tiles=torch.zeros(3, dtype=torch.int32,
                                           device="cuda"))


def _moe_run(cfg, params, paged):
    from repro_torch.models.model_zoo import Model
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import Batcher
    b = Batcher(Model(cfg), params, ServeConfig(
        max_len=64, batch=2, dtype=torch.float32, sync_every=4,
        paged=paged, page_size=8))
    rng = np.random.default_rng(0)
    for rid in range(5):
        b.submit(rid, rng.integers(0, cfg.vocab,
                                   size=int(rng.integers(4, 12))).tolist())
    return b.run(max_new=9), b


def test_moe_serving_through_kernels_matches_cpu_plain_path():
    """Reduced moonshot (1 dense + 2 MoE layers), float32, same weights,
    at capacity factor 8 and 0.5: the paged and dense batchers on the card
    give the CPU plain path's greedy tokens, and the expert GEMMs run
    three launches a MoE layer and forward call."""
    import dataclasses
    base = get_config("moonshot-v1-16b-a3b").reduced()
    params = init_params(base, 0, device="cuda")
    for factor in (8.0, 0.5):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=factor))
        for paged in (True, False):
            mg.reset_launch_counts()
            on_card, b = _moe_run(cfg, params, paged)
            calls = b.joins + 4 * b.segments
            assert mg.launch_counts["group_gemm"] == 3 * 2 * calls
            on_cpu, _ = _moe_run(cfg, _to_cpu(params), paged)
            assert on_card == on_cpu, (factor, paged)


def test_init_in_bfloat16_builds_no_float32_tree():
    """Full-width moonshot cut to 1 dense + 2 MoE layers: the bfloat16
    init's peak is the tree plus two float32 fill chunks, not a float32
    copy of the experts or of any leaf; the router and the read-out are
    float32."""
    import dataclasses
    from repro_torch.configs.base import BlockKind, Segment
    full = get_config("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(full, n_layers=3, segments=(
        Segment(BlockKind.DENSE, 1), Segment(BlockKind.MOE, 2)))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    moe = params["segments"][1]["moe"]
    tree = sum(t.numel() * t.element_size()
               for t in _leaves(params))
    experts = sum(moe[n].numel() for n in ("wi", "wg", "wo"))
    peak = torch.cuda.max_memory_allocated() - base
    assert moe["wi"].dtype == torch.bfloat16
    assert moe["router"]["w"].dtype == torch.float32
    assert params["lm_head"]["w"].dtype == torch.float32
    assert peak <= tree + 2 * 4 * FILL_CHUNK + (64 << 20), (peak, tree)
    assert peak < tree + experts * 2          # no float32 expert copy
    del params, moe


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the ops take strided views (their kernels take contiguous rows only)
# ---------------------------------------------------------------------------

def test_vector_sum_op_takes_strided_views():
    buf = torch.randn(64, 48, device="cuda")
    for a, b in ((buf.t(), (2 * buf).t()),              # transposed
                 (buf[:, ::3], buf[:, 1::3])):          # strided columns
        assert not a.is_contiguous()
        got = vs.vector_sum(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, a + b)


def test_flux1d_op_takes_strided_views():
    u = torch.randn(2, 243, 500, device="cuda")
    hi, lo = u[0].t(), u[1].t()                 # [500, 243], strided
    for alpha in (0.5, 0.3):
        got = wf.flux1d(hi, lo, alpha)
        want = wf.flux1d_ref(hi.contiguous(), lo.contiguous(), alpha)
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssgemm_ops_take_strided_views(dtype):
    rng = np.random.default_rng(9)
    a, b = _skinny(rng, 512, 300, 4, 0.5, dtype, 128)
    at = a.t().contiguous().t()                 # [300, 512] data, a's view
    assert not at.is_contiguous()
    bs = torch.stack([b, b], dim=2)[:, :, 0]    # b, columns 2 apart
    assert not bs.is_contiguous() and torch.equal(bs, b)
    a64, b64 = a.double(), b.double()
    want, bnd = a64 @ b64, a64.abs() @ b64.abs()
    for got in (sg.ssgemm_masked(at, bs, bk=128),
                sg.ssgemm_compact(at, bs, budget=2, bk=128),
                sg.ssgemm(at, bs)):
        torch.cuda.synchronize()
        assert _within_bound(got, want, bnd, 300)


# ---------------------------------------------------------------------------
# the decode segment as one CUDA graph per bucket
# ---------------------------------------------------------------------------

def _moe_cut():
    """Full-width moonshot cut to 1 dense + 2 MoE layers (``chip_smoke.py``
    phase 8's model)."""
    import dataclasses
    from repro_torch.configs.base import BlockKind, Segment
    full = get_config("moonshot-v1-16b-a3b")
    return dataclasses.replace(full, n_layers=3, segments=(
        Segment(BlockKind.DENSE, 1), Segment(BlockKind.MOE, 2)))


def _served(cfg, params, *, graphs, paged, requests, max_new=9, batch=2,
            sync_every=4, eos=None, temperature=0.0, seed=0, hooks=None,
            **features):
    """Serve ``requests`` in float32 (max_len 64, pages of 8, the serving
    ``features`` given: prefix cache, chunks, speculation); returns the
    results, the batcher and the decode kernels' launches of the run."""
    from repro_torch.models.model_zoo import Model
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import Batcher
    b = Batcher(Model(cfg), params, ServeConfig(
        max_len=64, batch=batch, dtype=torch.float32, sync_every=sync_every,
        paged=paged, page_size=8, temperature=temperature, **features),
        eos_id=eos, seed=seed, graphs=graphs)
    if hooks is not None:
        hooks(b)
    for rid, p in requests:
        b.submit(rid, p)
    for mod in (kernel, dattn, mg):
        mod.reset_launch_counts()
    res = b.run(max_new=max_new)
    torch.cuda.synchronize()
    counts = {**kernel.launch_counts, **dattn.launch_counts,
              **mg.launch_counts}
    return res, b, counts


def _prompts(vocab, n, seed=0, lo=3, hi=20):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, vocab, size=int(rng.integers(lo, hi))
                               ).tolist()) for rid in range(n)]


@pytest.mark.parametrize("arch", ["qwen", "moonshot"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_graphed_segments_match_eager(arch, paged):
    """Reduced qwen2-0.5b and phase 8's 3-layer full-width moonshot, in
    float32: the batcher replaying one CUDA graph per bucket gives the
    eager loop's greedy tokens, and the decode kernels' launches (counted
    at each replay from the capture's tally) equal the eager run's."""
    cfg = (get_config("qwen2-0.5b").reduced() if arch == "qwen"
           else _moe_cut())
    params = init_params(cfg, 0, device="cuda")
    requests = _prompts(cfg.vocab, 5)
    eager, eb, eager_counts = _served(cfg, params, graphs=False,
                                      paged=paged, requests=requests)
    graphed, gb, counts = _served(cfg, params, graphs=None, paged=paged,
                                  requests=requests)
    assert gb.graphs and not eb.graphs and gb.graph_count >= 1
    assert gb.capture_seconds > 0.0
    assert graphed == eager
    assert counts == eager_counts
    steps = gb.segments * 4
    decode = "paged_decode" if paged else "decode_attn"
    assert counts[decode] == cfg.n_layers * steps
    if arch == "moonshot":
        assert counts["group_gemm"] == 3 * 2 * (gb.joins + steps)


def test_graph_replays_around_a_join():
    """An EOS retires one slot early, so a join refills it between two
    replays of one bucket's graph: the graph must read the joined rows
    (the state is written in place), and the tokens are the eager
    run's."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_params(cfg, 0, device="cuda")
    requests = _prompts(cfg.vocab, 6, seed=3)
    free, _, _ = _served(cfg, params, graphs=False, paged=True,
                         requests=requests, max_new=12, sync_every=3)
    eos = free[1][4]
    events = []

    def hooks(b):
        loop, refill = b._loop, b._refill

        def logged_loop(steps, cap):
            drv = loop(steps, cap)
            events.append(("replay" if drv.graph is not None else "eager",
                           (steps, cap)))
            return drv

        def logged_refill(max_new):
            joins = b.joins
            refill(max_new)
            if b.joins > joins:
                events.append(("join", None))
        b._loop, b._refill = logged_loop, logged_refill
    want, _, _ = _served(cfg, params, graphs=False, paged=True,
                         requests=requests, max_new=12, sync_every=3,
                         eos=eos)
    got, _, _ = _served(cfg, params, graphs=None, paged=True,
                        requests=requests, max_new=12, sync_every=3,
                        eos=eos, hooks=hooks)
    assert got == want
    assert any(len(v) < 12 for v in got.values())
    joins = [j for j, (kind, _) in enumerate(events) if kind == "join"]
    around = [(i, j, k) for j in joins for i in range(j)
              for k in range(j + 1, len(events))
              if events[i][0] == "replay" and events[i] == events[k]]
    assert around, events


def test_bucket_change_mid_run_captures_a_graph_per_bucket():
    """Dense rows bounded by ``kv_cap``: as the slots deepen the bucket
    moves from 16 to 32 to 64 rows, each bucket gets its own graph, and
    the tokens are the eager run's."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_params(cfg, 0, device="cuda")
    requests = _prompts(cfg.vocab, 4, seed=5, lo=3, hi=8)
    want, _, eager_counts = _served(cfg, params, graphs=False, paged=False,
                                    requests=requests, max_new=40,
                                    sync_every=2)
    got, b, counts = _served(cfg, params, graphs=None, paged=False,
                             requests=requests, max_new=40, sync_every=2)
    assert got == want and counts == eager_counts
    caps = {cap for _, cap, _ in b._loops}
    assert {16, 32} <= caps
    assert b.graph_count >= 2


def test_sampled_graph_draws_fresh_noise_and_a_seed_repeats():
    """At a temperature above 0 each replay of a graph draws new noise
    from the batcher's generator (registered with the graph), and a seed
    reproduces the draws; without registration the capture raises."""
    from repro_torch.serve.engine import GraphedLoop, sample_tokens
    logits = torch.zeros(4, 1000, device="cuda")
    tok = torch.zeros(4, 1, dtype=torch.int32, device="cuda")

    def loop(params, tok, caches, lengths, done, remaining, gen,
             pages=None):
        draws = torch.stack([sample_tokens(logits, 1.0, gen)
                             for _ in range(3)])
        tok.copy_(draws[-1][:, None])
        return draws

    def draws(seed, sampled=True):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        drv = GraphedLoop(loop, stream=torch.cuda.Stream(),
                          pool=torch.cuda.graph_pool_handle(),
                          sampled=sampled)
        return [drv(None, tok, [], None, None, None, gen).clone()
                for _ in range(4)]
    a, b = draws(7), draws(7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert len({tuple(x.flatten().tolist()) for x in a}) == 4
    assert not torch.equal(draws(8)[2], a[2])
    with pytest.raises(RuntimeError):
        draws(7, sampled=False)


def test_sampled_batcher_is_graphed_and_a_seed_repeats():
    """A sampled batcher (temperature 0.8) replays graphs, and two runs
    from one seed give the same tokens."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_params(cfg, 0, device="cuda")
    requests = _prompts(cfg.vocab, 5)
    runs = [_served(cfg, params, graphs=None, paged=True, requests=requests,
                    temperature=0.8, seed=seed) for seed in (1, 1, 2)]
    assert all(b.graphs and b.graph_count >= 1 for _, b, _ in runs)
    assert runs[0][0] == runs[1][0]
    assert runs[0][0] != runs[2][0]
    for res, _, _ in runs:
        assert all(len(v) == 9 and all(0 <= t < cfg.vocab for t in v)
                   for v in res.values())


def test_graph_refuses_a_rebound_state_tensor():
    """A replay reads the captured addresses, so a graphed loop called with a
    state tensor other than the captured one raises."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_params(cfg, 0, device="cuda")
    _, b, _ = _served(cfg, params, graphs=None, paged=False,
                      requests=_prompts(cfg.vocab, 2), sync_every=2)
    key, drv = next((k, d) for k, d in b._loops.items()
                    if d.graph is not None)
    with pytest.raises(RuntimeError, match="captured"):
        drv(b.params, b.tok.clone(), b.caches, b.lengths, b.done,
            b.remaining, b.gen)


# ---------------------------------------------------------------------------
# the serving features: prefix cache, chunked prefill, speculation
# ---------------------------------------------------------------------------

SPEC = dict(speculate_k=3, prefix_cache=True, prefill_chunk=8)


def _spec_prompts(vocab):
    """Five prompts behind a 16-token shared prefix, one of them long
    enough to chunk."""
    system = _prompts(vocab, 1, seed=11, lo=16, hi=17)[0][1]
    return [(rid, system + p) for rid, p in _prompts(vocab, 5, seed=12,
                                                     lo=2, hi=26)]


def test_spec_bucket_is_captured_and_replayed():
    """Reduced qwen2-0.5b, float32, with speculation, the prefix cache and
    chunks of 8: the graphed batcher gives the eager loop's tokens, and
    the verify launches, counted at each replay, are the eager run's: the
    prefill kernel once a layer for each join and each verify step, the
    decode kernel never."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_params(cfg, 0, device="cuda")
    requests = _spec_prompts(cfg.vocab)
    want, eb, eager_counts = _served(cfg, params, graphs=False, paged=True,
                                     requests=requests, max_new=12, **SPEC)
    replays = []

    def hooks(b):
        loop = b._loop

        def logged(steps, cap):
            drv = loop(steps, cap)
            replays.append(drv.graph is not None)
            return drv
        b._loop = logged
    got, gb, counts = _served(cfg, params, graphs=None, paged=True,
                              requests=requests, max_new=12, hooks=hooks,
                              **SPEC)
    assert got == want and counts == eager_counts
    assert gb.graph_count >= 1 and any(replays)
    assert all(spec for _, _, spec in gb._loops)
    steps = gb.segments * 4
    assert counts["paged_prefill"] == cfg.n_layers * (gb.joins + steps)
    assert counts["paged_decode"] == 0
    assert gb.spec_stats() == eb.spec_stats()
    assert gb.spec_stats()["steps"] > 0 and gb.prefix_stats()["hits"] > 0
    assert gb.chunk_joins > 0


def test_spec_graph_refuses_a_rebound_history():
    """The token history is one of the tensors a speculative graph reads:
    a call with another history tensor raises."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_params(cfg, 0, device="cuda")
    _, b, _ = _served(cfg, params, graphs=None, paged=True,
                      requests=_spec_prompts(cfg.vocab), **SPEC)
    (steps, cap, _), drv = next((k, d) for k, d in b._loops.items()
                                if d.graph is not None)
    pages = b._pages[cap]
    with pytest.raises(RuntimeError, match="captured"):
        drv(b.params, b.tok, b.caches, b.lengths, b.done, b.remaining,
            b.gen, b.history.clone(), pages)



# ---------------------------------------------------------------------------
# optimistic admission and preemption
# ---------------------------------------------------------------------------

PREEMPT = dict(admission_mode="optimistic", total_pages=8)


def test_preemption_latches_the_device_row_in_place():
    """Reduced qwen2-0.5b, float32, batch 4 on an 8-page pool: optimistic
    admission preempts, and each victim's row of ``done`` and
    ``remaining`` is latched in place (done, no budget), so the tensors
    the decode graphs were captured with keep their addresses."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_params(cfg, 0, device="cuda")
    seen = []

    def hooks(b):
        preempt = b._preempt_slot

        def watched(slot, reason="pressure"):
            before = (b.done.data_ptr(), b.remaining.data_ptr())
            preempt(slot, reason)
            seen.append((before, (b.done.data_ptr(), b.remaining.data_ptr()),
                         bool(b.done[slot]), int(b.remaining[slot])))
        b._preempt_slot = watched
    _, b, _ = _served(cfg, params, graphs=None, paged=True,
                      requests=_prompts(cfg.vocab, 6), max_new=20, batch=4,
                      hooks=hooks, **PREEMPT)
    assert b.graph_count >= 1 and seen
    assert b.preempt_stats()["recomputed_ok"]
    for before, after, done, remaining in seen:
        assert before == after and done and remaining == 0


def test_graphed_optimistic_run_matches_eager():
    """The same preempting run graphed and eager: equal tokens, equal
    preemptions (events included), and equal launches, exact: the
    prefill kernel once a layer for each join (resume joins included),
    the decode kernel once a layer for each decode step."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_params(cfg, 0, device="cuda")
    requests = _prompts(cfg.vocab, 6)
    want, eb, eager_counts = _served(cfg, params, graphs=False, paged=True,
                                     requests=requests, max_new=20, batch=4,
                                     **PREEMPT)
    got, gb, counts = _served(cfg, params, graphs=None, paged=True,
                              requests=requests, max_new=20, batch=4,
                              **PREEMPT)
    assert got == want and counts == eager_counts
    assert gb.preempt_stats() == eb.preempt_stats()
    assert gb.preemptions > 0 and gb.preempted_token_recompute > 0
    assert gb.graph_count >= 1
    assert counts["paged_prefill"] == cfg.n_layers * gb.joins
    assert counts["paged_decode"] == cfg.n_layers * gb.segments * 4
    gb.pool.check()
    assert gb.pool.used_pages == 0


def test_cancel_latches_the_device_row_in_place():
    """Reduced qwen2-0.5b, float32, paged, graphed, batch 4: one request
    is cancelled mid-flight after its bucket's graph was captured.  Its
    row of ``done`` and ``remaining`` is latched in place (done, no
    budget), a graph replays after the cancel on the tensors it was
    captured with (a rebound one raises), every other request gives the
    tokens of the run without the cancel, and the pool drains."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_params(cfg, 0, device="cuda")
    requests = _prompts(cfg.vocab, 4, seed=2)
    kw = dict(graphs=None, paged=True, requests=requests, max_new=16,
              batch=4, sync_every=2)
    want, _, _ = _served(cfg, params, **kw)
    seen, replays = [], []

    def hooks(b):
        collect, loop = b._collect, b._loop

        def logged(steps, cap):
            drv = loop(steps, cap)
            replays.append((drv.graph is not None, bool(seen)))
            return drv

        def cancelling(emitted):
            collect(emitted)
            if b.segments == 2 and not seen:
                slot = next(i for i, r in enumerate(b.slot_rid)
                            if r is not None)
                rid = b.slot_rid[slot]
                before = (b.done.data_ptr(), b.remaining.data_ptr())
                assert b.cancel(rid)
                seen.append((rid, before,
                             (b.done.data_ptr(), b.remaining.data_ptr()),
                             bool(b.done[slot]), int(b.remaining[slot])))
        b._collect, b._loop = cancelling, logged
    got, b, _ = _served(cfg, params, hooks=hooks, **kw)
    ((rid, before, after, done, remaining),) = seen
    assert before == after and done and remaining == 0
    assert b.cancelled == {rid: "client"} and rid not in got
    assert any(graph and cancelled for graph, cancelled in replays)
    assert got == {k: v for k, v in want.items() if k != rid}
    b.pool.check()
    assert b.pool.used_pages == 0
