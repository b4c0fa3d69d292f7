"""Port paged-attention ops vs the JAX package's Pallas kernels (run in
interpret mode, as the JAX tests run them on the CPU): ragged lengths,
permuted page tables, sentinel tails, prefill at mixed per-slot depths and
the k+1 verify; a slot of length 0 (zeros, as the kernels give); the
decode kernels' split-KV schedule (``split``) and its split-then-combine
plain version.  On the CPU the port's ops run their plain PyTorch
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
from repro_torch.kernels.decode_attn import ref as dense_ref
from repro_torch.kernels.paged_attn import (gather_pages, kernel, ops,
                                            paged_attn, paged_attn_ref,
                                            paged_prefill_attn,
                                            paged_prefill_attn_ref,
                                            paged_verify_attn, ref, split)

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


@pytest.mark.parametrize("b,hq,hkv,d,ps", [
    (6, 4, 1, 16, 8),      # reduced qwen2-0.5b geometry (G=4, D=16)
    (6, 14, 2, 64, 16),    # full-width qwen2-0.5b geometry (G=7, D=64)
])
def test_length_zero_matches_pallas_kernel(b, hq, hkv, d, ps):
    """Lengths 0, 1, ps - 1, ps and a full table: the Pallas kernel
    computes no page of a length-0 slot and gives zeros, and so does the
    port (the plain version JAX's XLA path follows would average V)."""
    rng = np.random.default_rng(hq + ps)
    n, p_max = 32, 4
    lengths = [0, 1, ps - 1, 0, ps, p_max * ps][:b]
    k, v, tbl = _pages(rng, b, hq, hkv, d, n, ps, p_max, lengths)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    want = jax_paged_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(tbl), jnp.asarray(ln), interpret=True)
    got = paged_attn(_t(q), _t(k), _t(v), _t(tbl), _t(ln))
    np.testing.assert_array_equal(got[[0, 3]].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_versions_agree_at_length_zero():
    """The paged plain version and the dense one give the same zeros at
    length 0, and agree at every other length, on the same keys."""
    rng = np.random.default_rng(11)
    lengths = [0, 1, 7, 0, 32]
    k, v, tbl = _pages(rng, 5, 8, 2, 16, 24, 8, 4, lengths)
    q = _t(rng.standard_normal((5, 8, 16)).astype(np.float32))
    ln = _t(np.asarray(lengths, np.int32))
    paged = paged_attn_ref(q, _t(k), _t(v), _t(tbl), ln)
    dense = dense_ref.decode_attn_ref(q, gather_pages(_t(k), _t(tbl)),
                                      gather_pages(_t(v), _t(tbl)), ln)
    np.testing.assert_array_equal(paged[[0, 3]].numpy(), 0.0)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), **TOL)


def test_prefill_row_that_sees_no_key_matches_pallas_kernel():
    """A prefill slot with kv_len 0: the Pallas kernel gives zeros there,
    and so does the port's plain version."""
    rng = np.random.default_rng(12)
    k, v, tbl = _pages(rng, 3, 4, 1, 16, 16, 8, 4, [0, 9, 20])
    q = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    off = np.asarray([0, 4, 15], np.int32)
    kvl = np.asarray([0, 9, 20], np.int32)
    want = paged_prefill_attn_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl),
        jnp.asarray(off), jnp.asarray(kvl), interpret=True)
    got = paged_prefill_attn(_t(q), _t(k), _t(v), _t(tbl), _t(off),
                             _t(kvl))
    np.testing.assert_array_equal(got[0].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_ranges_cover_every_key_once(splits):
    """For every slot length from 0 to 1,100: the ranks' ranges tile
    [0, n) in order, each starts on a tile, ranks past the slot's last
    tile are empty, and the live ranges differ by less than a tile but
    for the last one."""
    for n in range(0, 1101):
        ranges = [split.split_range(r, splits, n) for r in range(splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2
        for lo, hi in ranges:
            assert lo <= hi and (lo == hi == n or lo % split.TILE == 0)
        sizes = [hi - lo for lo, hi in ranges if hi > lo]
        assert all(x == sizes[0] for x in sizes[:-1])
        tiles = -(-n // split.TILE)
        per = -(-tiles // splits)             # tiles of each live rank
        assert len(sizes) == (-(-tiles // per) if tiles else 0)


@pytest.mark.parametrize("batch,hkv,group,bound,sms,want", [
    (8, 2, 7, 1024, 132, 8),    # qwen2-0.5b serve: 8 x 2 x 4 row groups
    (8, 16, 1, 1024, 132, 4),   # moonshot serve (D 128): 128 pairs
    (8, 2, 16, 1024, 132, 4),   # G 16: 8 row groups a KV head
    (66, 1, 1, 1024, 132, 4),   # 264 CTAs at 4 a pair
    (300, 1, 1, 1024, 132, 1),  # enough pairs already
    (17, 16, 2, 1024, 132, 1),  # 272 pairs, one row group each
    (8, 2, 7, 32, 132, 2),      # two tiles of keys: two ranks at most
    (1, 1, 1, 0, 132, 1),       # no key at all
    (2, 1, 1, 100, 132, 4),     # 7 tiles
    (8, 16, 1, 1024, 64, 1),    # a card of 64 SMs: 128 pairs are enough
    (8, 2, 7, 1024, 16, 1),     # 64 CTAs on 16 SMs
])
def test_split_count(batch, hkv, group, bound, sms, want):
    s = split.split_count(batch, hkv, group, bound, sms)
    assert s == want and s in (1, 2, 4, split.MAX_SPLITS)
    assert split.row_groups(group) == -(-group // split.CTA_ROWS)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_combine_matches_pallas_kernel(splits):
    """The split-then-combine plain version, at lengths 0, 1, shorter than
    ``splits`` tiles and one key before, at and past each rank boundary,
    against the Pallas kernel: the merge of the ranks' states is the
    softmax of the whole slot, and empty ranks add nothing."""
    rng = np.random.default_rng(splits)
    hq, hkv, d, ps, p_max = 4, 2, 16, 8, 48
    bound = p_max * ps
    lengths = sorted({0, 1, splits * split.TILE - 1}
                     | set(split.boundary_lengths(splits, bound)))
    k, v, tbl = _pages(rng, len(lengths), hq, hkv, d, 2400, ps, p_max,
                       lengths)
    q = rng.standard_normal((len(lengths), hq, d)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    want = jax_paged_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(tbl), jnp.asarray(ln), interpret=True)
    got = ref.decode_split_ref(_t(q), gather_pages(_t(k), _t(tbl)),
                               gather_pages(_t(v), _t(tbl)), _t(ln), splits)
    np.testing.assert_array_equal(got[0].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
