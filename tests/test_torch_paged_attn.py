"""Port paged-attention ops vs the JAX package's Pallas kernels (run in
interpret mode, as the JAX tests run them on the CPU): ragged lengths,
permuted page tables, sentinel tails, prefill at mixed per-slot depths and
the k+1 verify.  On the CPU the port's ops run their plain PyTorch
versions; the CUDA kernels are held against those same versions on the
card by ``tests/test_torch_cuda.py``.

Tolerance: float32 on both sides, atol = rtol = 1e-5 (the two frameworks
sum in different orders; the results agree to about 1e-6)."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn import gather_pages as jax_gather_pages
from repro.kernels.paged_attn import paged_attn as jax_paged_attn
from repro.kernels.paged_attn import paged_prefill_attn_pallas
from repro_torch.kernels.paged_attn import (gather_pages, kernel, ops,
                                            paged_attn, paged_attn_ref,
                                            paged_prefill_attn,
                                            paged_prefill_attn_ref,
                                            paged_verify_attn)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _pages(rng, b, hq, hkv, d, n, ps, p_max, depths):
    """numpy inputs: each slot maps ceil(depth / ps) random distinct pages
    of a pool of n; the rest of its row is the sentinel n."""
    k = rng.standard_normal((n, ps, hkv, d)).astype(np.float32)
    v = rng.standard_normal((n, ps, hkv, d)).astype(np.float32)
    tbl = np.full((b, p_max), n, np.int32)
    perm = list(rng.permutation(n))
    for i, ln in enumerate(depths):
        for j in range(-(-ln // ps)):
            tbl[i, j] = perm.pop()
    return k, v, tbl


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b,hq,hkv,d,ps", [
    (3, 4, 1, 16, 8),      # reduced qwen2-0.5b geometry (G=4, D=16)
    (2, 14, 2, 64, 16),    # full-width qwen2-0.5b geometry (G=7, D=64)
    (2, 8, 8, 32, 4),      # MHA
])
def test_decode_matches_pallas_kernel(b, hq, hkv, d, ps):
    rng = np.random.default_rng(hq * d + ps)
    n, p_max = 24, 8
    lengths = [int(rng.integers(1, p_max * ps)) for _ in range(b)]
    lengths[0] = p_max * ps - ps + 1          # one row into the last page
    k, v, tbl = _pages(rng, b, hq, hkv, d, n, ps, p_max, lengths)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    want = jax_paged_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(tbl), jnp.asarray(ln), interpret=True)
    got = paged_attn(_t(q), _t(k), _t(v), _t(tbl), _t(ln))
    assert got.dtype == torch.float32 and got.shape == (b, hq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ln", [1, 7, 8, 9, 64])
def test_decode_page_boundaries(ln):
    """Partial last page, exact fill and a one-token slot."""
    rng = np.random.default_rng(ln)
    k, v, tbl = _pages(rng, 1, 4, 2, 16, 16, 8, 8, [ln])
    q = rng.standard_normal((1, 4, 16)).astype(np.float32)
    lens = np.asarray([ln], np.int32)
    want = jax_paged_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(tbl), jnp.asarray(lens),
                          interpret=True)
    got = paged_attn(_t(q), _t(k), _t(v), _t(tbl), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,hq,hkv,d,ps,lq,offsets", [
    (3, 4, 1, 16, 8, 6, [0, 5, 17]),          # reduced, mixed depths
    (2, 14, 2, 64, 16, 20, [0, 37]),          # full width, crosses pages
    (3, 4, 1, 16, 8, 5, [3, 40, 0]),          # verify: Lq = k+1 = 5
])
def test_prefill_matches_pallas_kernel(b, hq, hkv, d, ps, lq, offsets):
    rng = np.random.default_rng(lq * 7 + d)
    n, p_max = 32, 10
    kv_len = [o + lq for o in offsets]
    k, v, tbl = _pages(rng, b, hq, hkv, d, n, ps, p_max, kv_len)
    q = rng.standard_normal((b, lq, hq, d)).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    kvl = np.asarray(kv_len, np.int32)
    want = paged_prefill_attn_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl),
        jnp.asarray(off), jnp.asarray(kvl), interpret=True)
    got = paged_prefill_attn(_t(q), _t(k), _t(v), _t(tbl), _t(off), _t(kvl))
    assert got.shape == (b, lq, hq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    verify = paged_verify_attn(_t(q), _t(k), _t(v), _t(tbl), _t(off),
                               _t(kvl))
    np.testing.assert_array_equal(verify.numpy(), got.numpy())


def test_prefill_all_sentinel_rows_are_finite():
    """A join's non-joining rows carry all-sentinel tables: their output
    is discarded, but it must be finite and must not fault."""
    rng = np.random.default_rng(3)
    k, v, tbl = _pages(rng, 2, 4, 1, 16, 8, 8, 4, [9, 0])
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    got = paged_prefill_attn(_t(q), _t(k), _t(v), _t(tbl),
                             torch.zeros(2, dtype=torch.int32),
                             torch.full((2,), 9, dtype=torch.int32))
    assert torch.isfinite(got).all()


def test_gather_and_clamp_match_jax():
    rng = np.random.default_rng(5)
    k, _, tbl = _pages(rng, 3, 4, 2, 16, 12, 4, 5, [3, 20, 9])
    want = jax_gather_pages(jnp.asarray(k), jnp.asarray(tbl))
    np.testing.assert_array_equal(gather_pages(_t(k), _t(tbl)).numpy(),
                                  np.asarray(want))
    clamped = ops._clamp_table(_t(tbl), 12)
    assert clamped.dtype == torch.int32
    np.testing.assert_array_equal(clamped.numpy(), np.minimum(tbl, 11))


def test_refs_agree_on_one_token_prefill():
    """Decode is the one-token case of the prefill ref at depth len-1."""
    rng = np.random.default_rng(9)
    k, v, tbl = _pages(rng, 2, 4, 1, 16, 10, 8, 4, [13, 30])
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    ln = _t(np.asarray([13, 30], np.int32))
    dec = paged_attn_ref(_t(q), _t(k), _t(v), _t(tbl), ln)
    pre = paged_prefill_attn_ref(_t(q)[:, None], _t(k), _t(v), _t(tbl),
                                 ln - 1, ln)[:, 0]
    np.testing.assert_allclose(dec.numpy(), pre.numpy(), **TOL)


def test_kernel_wrappers_reject_cpu_tensors():
    """The launch wrappers never run a plain version: a CPU tensor is an
    error there (ops routes CPU tensors to ref before reaching them)."""
    q = torch.zeros(1, 4, 16)
    pool = torch.zeros(3, 8, 1, 16)
    tbl = torch.zeros(1, 2, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    before = dict(kernel.launch_counts)
    with pytest.raises(ValueError, match="must be on"):
        kernel.paged_attn_cuda(q, pool, pool, tbl, ln)
    with pytest.raises(ValueError, match="must be on"):
        kernel.paged_prefill_attn_cuda(q[:, None], pool, pool, tbl, ln, ln)
    assert kernel.launch_counts == before


def test_build_dir_is_inside_the_checkout():
    root = pathlib.Path(kernel.__file__).resolve().parents[4]
    assert (root / "src" / "repro_torch").is_dir()
    assert kernel.build_dir() == root / "build" / "paged_attn"
