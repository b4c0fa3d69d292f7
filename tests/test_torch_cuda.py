"""The port on the card: each CUDA kernel against its plain PyTorch
version, the wrappers' refusals, and the serving paths (paged and dense)
through the kernels against the plain path on the CPU and against each
other; the paper's primitives (skinny GEMM, push scatter) through their
kernels against float64 oracles.  Every test here is marked ``cuda`` and skips without a GPU;
on a GPU machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor ``repro``, so it runs where only the
port is installed.  Tolerances: float32 1e-4, bfloat16 2e-2 (max abs
error against the plain version evaluated in float32 on the same values;
TF32 is off).  The primitives' kernels sum in float32 in an order of their
own (atomics, for push), so they are held per output to the worst-case
bound of float32 summation, n u / (1 - n u) times the sum of the terms'
magnitudes (u = 2**-24, n the terms summed), against float64 results
from the same, already rounded, inputs."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attn as dattn
from repro_torch.kernels import push_scatter as ps
from repro_torch.kernels import ss_gemm as sg
from repro_torch.kernels.paged_attn import (kernel, paged_attn,
                                            paged_attn_ref,
                                            paged_prefill_attn,
                                            paged_prefill_attn_ref)
from repro_torch.launch.serve import run
from repro_torch.models.init import init_params

torch.set_num_threads(1)

# the condition is a string, so pytest evaluates it when each test runs
pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs a CUDA GPU (the kernels have "
                                        "no CPU mode)")]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GEOMETRIES = [(4, 1, 16, 8),       # reduced qwen2-0.5b
              (14, 2, 64, 16),     # full-width qwen2-0.5b
              (16, 2, 64, 8)]      # G = 8, pages of 8


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,ps", GEOMETRIES)
def test_decode_kernel_matches_plain_version(dtype, hq, hkv, d, ps):
    rng = np.random.default_rng(hq + d)
    lengths = [1, ps - 1, ps, ps + 1, 7 * ps + 3]
    k, v, tbl = _pages(rng, 5, hkv, d, 40, ps, 9, lengths, dtype)
    q = torch.randn(5, hq, d, device="cuda").to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = kernel.launch_counts["paged_decode"]
    got = paged_attn(q, k, v, tbl, ln)
    assert kernel.launch_counts["paged_decode"] == before + 1
    want = paged_attn_ref(q.float(), k.float(), v.float(), tbl, ln)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,ps", GEOMETRIES)
@pytest.mark.parametrize("lq,offsets", [(5, [0, 3, 17, 60, 100]),
                                        (37, [0, 0, 9, 31, 64])])
def test_prefill_kernel_matches_plain_version(dtype, hq, hkv, d, ps, lq,
                                              offsets):
    rng = np.random.default_rng(hq + d + lq)
    kv_len = [o + lq for o in offsets]
    k, v, tbl = _pages(rng, 5, hkv, d, 80, ps, 16, kv_len, dtype)
    q = torch.randn(5, lq, hq, d, device="cuda").to(dtype)
    off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    kvl = off + lq
    before = kernel.launch_counts["paged_prefill"]
    got = paged_prefill_attn(q, k, v, tbl, off, kvl)
    assert kernel.launch_counts["paged_prefill"] == before + 1
    want = paged_prefill_attn_ref(q.float(), k.float(), v.float(), tbl, off,
                                  kvl)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


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


STRIPE_GEOMETRIES = [(4, 1, 16),     # reduced qwen2-0.5b (G = 4)
                     (14, 2, 64),    # full-width qwen2-0.5b (G = 7)
                     (16, 1, 64)]    # G = 16, the kernel's largest group


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", STRIPE_GEOMETRIES)
@pytest.mark.parametrize("s_cap", [None, 100])
def test_decode_attn_kernel_matches_plain_version(dtype, hq, hkv, d, s_cap):
    """Ragged lengths: 0 (zeros), 1, tile edges, and lengths above the
    rows read; with ``s_cap`` the rows past it hold NaN and must never be
    read."""
    rng = np.random.default_rng(hq + d)
    b, s = 6, 160
    lengths = [0, 1, 63, 64, 65, s + 5]

    def stripe():
        a = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
        if s_cap is not None:
            a[:, s_cap:] = np.nan
        return torch.from_numpy(a).to("cuda").to(dtype)
    k, v = stripe(), stripe()
    q = torch.randn(b, hq, d, device="cuda").to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = dattn.launch_counts["decode_attn"]
    got = dattn.decode_attn(q, k, v, ln, s_cap=s_cap)
    assert dattn.launch_counts["decode_attn"] == before + 1
    cap = s if s_cap is None else s_cap
    want = dattn.decode_attn_ref(q.float(), k[:, :cap].float(),
                                 v[:, :cap].float(), ln)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    assert bool((got[0] == 0).all())
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
                 (77, 520, 256)]     # ragged M, K % 8 == 0, ragged last block


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("m,k,bk", SKINNY_SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
def test_ssgemm_kernels_match_plain_version(dtype, n, m, k, bk, density):
    """Both walks against their plain versions in float64 on the same
    values, within the worst-case float32 summation bound; the compact op
    at budgets 1, the live count and every block (the first takes the
    overflow guard whenever two or more blocks are live)."""
    rng = np.random.default_rng(m + n + int(100 * density))
    a, b = _skinny(rng, m, k, n, density, dtype, bk)
    a64, b64 = a.double(), b.double()
    mask = sg.block_occupancy(b, bk)
    before = dict(sg.launch_counts)
    got = sg.kernel.ssgemm_masked_cuda(a, b, mask, bk)
    assert sg.launch_counts["ssgemm_masked"] == before["ssgemm_masked"] + 1
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
