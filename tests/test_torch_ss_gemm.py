"""Port sparse skinny GEMM vs the JAX package: the occupancy mask, the
masked and compact ops and the dense entry point against the JAX ops (their
Pallas kernels in interpret mode, as the JAX tests run them on the CPU) at
the shapes of ``tests/test_kernels_ss_gemm.py``; the kernel-level plain
versions against the JAX kernels on the kernels' own arguments; a ragged K,
where the JAX Pallas op returns NaN in interpret mode and the port is
exact against the JAX oracle ``ssgemm_ref``; and the budget's range.  On
the CPU the port's ops run their plain PyTorch versions; the CUDA kernels
are held against those same versions on the card by
``tests/test_torch_cuda.py``.

Tolerances (the JAX test's): float32 rtol 1e-4, atol 1e-3; bfloat16 rtol
and atol 2e-2 (both sides multiply the same bfloat16 values and sum in
float32, in different orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ss_gemm import ssgemm as jax_ssgemm
from repro.kernels.ss_gemm import ssgemm_compact as jax_compact
from repro.kernels.ss_gemm import ssgemm_masked as jax_masked
from repro.kernels.ss_gemm.kernel import (ssgemm_compact_kernel,
                                          ssgemm_masked_kernel)
from repro.kernels.ss_gemm.ops import block_occupancy as jax_occupancy
from repro.kernels.ss_gemm.ref import ssgemm_ref as jax_ref
from repro_torch.kernels import ss_gemm as sg

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def make(m, k, n, density, dtype, seed=0):
    """The JAX test's inputs (rows of B zeroed with probability
    1 - density), as a JAX pair and a torch pair of the same values."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    b[rng.random(k) > density] = 0.0
    jdt, tdt = DTYPES[dtype]
    return ((jnp.asarray(a, jdt), jnp.asarray(b, jdt)),
            (torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("k,bk,density", [(512, 128, 0.3), (300, 128, 0.1),
                                          (1024, 256, 0.02), (100, 100, 1.0),
                                          (256, 64, 0.0)])
def test_block_occupancy_matches_jax(k, bk, density):
    (_, jb), (_, tb) = make(8, k, 4, density, "float32", seed=k + bk)
    got = sg.block_occupancy(tb, bk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_occupancy(jb,
                                                                        bk)))


@pytest.mark.parametrize("m,k,n", [(256, 256, 2), (512, 384, 4),
                                   (128, 1024, 8), (384, 512, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_matches_jax(m, k, n, dtype):
    (ja, jb), (ta, tb) = make(m, k, n, density=0.4, dtype=dtype, seed=m + n)
    got = sg.ssgemm_masked(ta, tb, bm=128, bk=128)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(),
                               _np(jax_masked(ja, jb, bm=128, bk=128)),
                               **TOL[dtype])


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
def test_masked_density_extremes_match_jax(density):
    (ja, jb), (ta, tb) = make(256, 512, 4, density, "float32", seed=3)
    got = sg.ssgemm_masked(ta, tb, bm=128, bk=128)
    np.testing.assert_allclose(got.numpy(),
                               _np(jax_masked(ja, jb, bm=128, bk=128)),
                               **TOL["float32"])


@pytest.mark.parametrize("budget", [1, 2, 4, 8])
def test_compact_budgets_match_jax(budget):
    """Exact for any budget: live blocks past it go through the plain
    overflow product, on both sides."""
    (ja, jb), (ta, tb) = make(256, 1024, 4, density=0.25, dtype="float32",
                              seed=7)
    assert int(sg.block_occupancy(tb, 128).sum()) == 8   # budget 1-4 overflow
    got = sg.ssgemm_compact(ta, tb, budget=budget, bm=128, bk=128)
    np.testing.assert_allclose(
        got.numpy(), _np(jax_compact(ja, jb, budget=budget, bm=128, bk=128)),
        **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aware", [True, False])
def test_ssgemm_entry_point_matches_jax(dtype, aware):
    (ja, jb), (ta, tb) = make(256, 768, 8, density=0.3, dtype=dtype, seed=9)
    got = sg.ssgemm(ta, tb, sparsity_aware=aware)
    np.testing.assert_allclose(got.numpy(),
                               _np(jax_ssgemm(ja, jb, sparsity_aware=aware)),
                               **TOL[dtype])


def test_kernel_plain_versions_match_jax_kernels():
    """On the kernels' own arguments: a mask that skips live blocks too,
    and a list walked out of order with a repeated tail past n_live."""
    (ja, jb), (ta, tb) = make(256, 1024, 4, density=1.0, dtype="float32",
                              seed=13)
    mask = np.array([1, 0, 0, 1, 1, 0, 1, 0], np.int32)
    got = sg.ssgemm_masked_ref(ta, tb, torch.from_numpy(mask), 128)
    want = ssgemm_masked_kernel(ja, jb, jnp.asarray(mask), bm=128, bk=128)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL["float32"])
    idx = np.array([6, 2, 5, 5, 5], np.int32)
    n_live = np.array([3], np.int32)
    got = sg.ssgemm_compact_ref(ta, tb, torch.from_numpy(idx),
                                torch.from_numpy(n_live), 128)
    want = ssgemm_compact_kernel(ja, jb, jnp.asarray(idx),
                                 jnp.asarray(n_live), budget=5, bm=128,
                                 bk=128)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL["float32"])


@pytest.mark.parametrize("m,k,op", [(300, 300, "masked"),
                                    (256, 320, "masked"),
                                    (200, 300, "compact")])
def test_ragged_k_is_exact_where_the_jax_pallas_op_gives_nan(m, k, op):
    """K not a multiple of bk: the JAX Pallas op (interpret mode) reads the
    padding of the last k-block and returns NaN; the port reads no column
    past K and agrees with the JAX oracle."""
    (ja, jb), (ta, tb) = make(m, k, 4, density=1.0, dtype="float32", seed=k)
    if op == "masked":
        jax_out = jax_masked(ja, jb, bm=128, bk=128)
        got = sg.ssgemm_masked(ta, tb, bm=128, bk=128)
    else:        # budget 3 of 3 blocks: the ragged one is in the kernel
        jax_out = jax_compact(ja, jb, budget=3, bm=128, bk=128)
        got = sg.ssgemm_compact(ta, tb, budget=3, bm=128, bk=128)
    assert np.isnan(_np(jax_out)).any()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _np(jax_ref(ja, jb)),
                               **TOL["float32"])


def test_ragged_m_matches_jax():
    """M not a multiple of bm: exact on both sides."""
    (ja, jb), (ta, tb) = make(300, 256, 4, density=0.5, dtype="float32",
                              seed=1)
    np.testing.assert_allclose(
        sg.ssgemm_masked(ta, tb, bm=128, bk=128).numpy(),
        _np(jax_masked(ja, jb, bm=128, bk=128)), **TOL["float32"])


def test_budget_outside_the_blocks_raises():
    """budget must be in [1, n_blocks]: the port raises ValueError; the JAX
    op fails with a broadcasting error past n_blocks."""
    (ja, jb), (ta, tb) = make(64, 512, 4, density=0.5, dtype="float32")
    for budget in (0, 5):
        with pytest.raises(ValueError):
            sg.ssgemm_compact(ta, tb, budget=budget, bk=128)
    with pytest.raises(ValueError, match="broadcast"):
        jax_compact(ja, jb, budget=5, bm=128, bk=128)
    got = sg.ssgemm_compact(ta, tb, budget=4, bk=128)
    np.testing.assert_allclose(got.numpy(), _np(jax_ref(ja, jb)),
                               **TOL["float32"])


def test_cpu_tensors_take_the_plain_path_and_the_kernel_refuses_them():
    """Routing is by device: CPU tensors never launch, and the CUDA
    wrapper raises on them before it builds anything."""
    (_, _), (ta, tb) = make(64, 256, 4, density=0.5, dtype="float32")
    before = dict(sg.launch_counts)
    sg.ssgemm_masked(ta, tb)
    sg.ssgemm_compact(ta, tb, budget=1)
    assert sg.launch_counts == before
    mask = sg.block_occupancy(tb, 256)
    with pytest.raises(ValueError, match="CUDA"):
        sg.kernel.ssgemm_masked_cuda(ta, tb, mask, 256)
    with pytest.raises(ValueError, match="CUDA"):
        sg.kernel.ssgemm_compact_cuda(ta, tb, mask, mask, 256)


@pytest.mark.parametrize("dtype,k,bk,a_off,b_off,want", [
    ("bfloat16", 4096, 256, 0, 0, "tensor_core"),   # Problem(), JAX's bk
    ("bfloat16", 520, 256, 0, 0, "tensor_core"),    # a short last block
    ("bfloat16", 64, 16, 0, 0, "tensor_core"),      # the smallest bk
    ("bfloat16", 300, 128, 0, 0, "cuda_core"),      # K % 8 != 0
    ("bfloat16", 512, 200, 0, 0, "cuda_core"),      # bk % 16 != 0
    ("bfloat16", 512, 128, 1, 0, "cuda_core"),      # A 2 bytes off 16
    ("bfloat16", 512, 128, 0, 1, "cuda_core"),      # B 2 bytes off 16
    ("float32", 4096, 256, 0, 0, "cuda_core"),      # float32
    ("float32", 300, 128, 0, 0, "cuda_core"),
])
def test_route_by_dtype_shape_and_alignment(dtype, k, bk, a_off, b_off,
                                            want):
    """The rule the CUDA wrappers launch by, held on CPU tensors: the
    tensor-core walk takes bfloat16 with whole 16-byte rows of A, 16-byte
    aligned A and B and bk % 16 == 0; the CUDA-core walk the rest."""
    tdt = DTYPES[dtype][1]
    a = torch.zeros(32 * k + a_off, dtype=tdt)[a_off:].view(32, k)
    b = torch.zeros(k * 4 + b_off, dtype=tdt)[b_off:].view(k, 4)
    assert sg.route(a, b, bk) == want


def test_route_counts_reset_with_launch_counts():
    sg.kernel.route_counts["tensor_core"] += 3
    sg.kernel.launch_counts["ssgemm_masked"] += 3
    sg.reset_launch_counts()
    assert sg.route_counts == {"tensor_core": 0, "cuda_core": 0}
    assert sg.launch_counts == {"ssgemm_masked": 0, "ssgemm_compact": 0}
