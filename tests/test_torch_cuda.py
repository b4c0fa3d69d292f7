"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the serving path through the kernels against the plain path
on the CPU.  Every test here is marked ``cuda`` and skips without a GPU;
on a GPU machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor ``repro``, so it runs where only the
port is installed.  Tolerances: float32 1e-4, bfloat16 2e-2 (max abs
error against the plain version evaluated in float32 on the same values;
TF32 is off)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
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
              page_size=8, sync_every=4, dtype=torch.float32)
    kernel.reset_launch_counts()
    on_card = run("qwen2-0.5b", device="cuda", params=params, **kw)
    assert min(kernel.launch_counts.values()) > 0
    on_cpu = run("qwen2-0.5b", device="cpu", params=_to_cpu(params), **kw)
    assert on_card["results"] == on_cpu["results"]


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()
