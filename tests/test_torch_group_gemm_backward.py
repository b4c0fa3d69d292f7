"""The grouped expert GEMM's backward on the CPU: the plain versions of
its three kernels against JAX, their NaN safety, the dw kernel's tiling
arithmetic, and the wrappers' refusal of CPU tensors.

JAX computes the expert products as einsums, so its dxe and dw are its
autodiff of them outside any Pallas kernel: the port's plain dxe and dw
(``ref.group_gemm_dxe_ref``, ``ref.group_gemm_dw_ref``) are held to
``jax.vjp`` of ``repro.kernels.moe_group_gemm.ref.group_gemm_ref`` on the
same numpy inputs, in float32, within 1e-5 of the largest entry (both sum
in float32 in orders of their own).  ``xe`` is zero past each count, as
the dispatch leaves it; ``dy`` is not (JAX's ``where`` drops those rows,
the port's plain versions select them away)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_group_gemm.ref import group_gemm_ref as jax_ref
from repro_torch.kernels import moe_group_gemm as mg
from repro_torch.kernels.moe_group_gemm import kernel, ref

torch.set_num_threads(1)

# (E, C, D, F, counts): empty, one row, a non-multiple of the 64-row
# stage, and a full expert; C itself a non-multiple of the tiles; a count
# past C (acts as C) and a negative one (acts as 0)
CASES = [(4, 80, 24, 40, [0, 1, 70, 80]),
         (3, 130, 16, 32, [129, 64, 0]),
         (5, 20, 8, 16, [20, 3, 0, 25, -2])]


def _inputs(seed, e, c, d, f, counts):
    rng = np.random.default_rng(seed)
    cnt = np.asarray(counts, np.int32)
    live = np.arange(c)[None, :, None] < cnt[:, None, None]
    xe = (rng.standard_normal((e, c, d)) * live).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    dy = rng.standard_normal((e, c, f)).astype(np.float32)
    return xe, w, dy, cnt, live


def _close(got: torch.Tensor, want, rel: float = 1e-5) -> None:
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got.numpy() - want).max()) <= rel * scale


@pytest.mark.parametrize("e,c,d,f,counts", CASES)
def test_plain_dxe_and_dw_match_jax_vjp(e, c, d, f, counts):
    xe, w, dy, cnt, _ = _inputs(e + c, e, c, d, f, counts)
    jc = jnp.asarray(cnt)
    _, vjp = jax.vjp(lambda x, v: jax_ref(x, v, jc), jnp.asarray(xe),
                     jnp.asarray(w))
    want_dxe, want_dw = vjp(jnp.asarray(dy))
    tx, tw, tdy, tc = map(torch.from_numpy, (xe, w, dy, cnt))
    dxe = ref.group_gemm_dxe_ref(tdy, tw, tc)
    dw = ref.group_gemm_dw_ref(tx, tdy, tc)
    assert dxe.dtype == dw.dtype == torch.float32
    assert dxe.shape == (e, c, d) and dw.shape == (e, d, f)
    _close(dxe, want_dxe)
    _close(dw, want_dw)


@pytest.mark.parametrize("e,c,d,f,counts", CASES)
def test_plain_backward_ignores_nan_past_the_counts(e, c, d, f, counts):
    """NaN in dy and xe past each count: everything finite, dxe's rows
    there exactly 0, an empty expert's dw exactly 0, the rest equal to
    the clean inputs' results, and the mask-and-cast's rows there 0."""
    xe, w, dy, cnt, live = _inputs(e * c, e, c, d, f, counts)
    tx, tw, tdy, tc = map(torch.from_numpy, (xe, w, dy, cnt))
    dead = torch.from_numpy(~live)
    x_nan = tx.masked_fill(dead, float("nan"))
    dy_nan = tdy.masked_fill(dead, float("nan"))
    dxe = ref.group_gemm_dxe_ref(dy_nan, tw, tc)
    dw = ref.group_gemm_dw_ref(x_nan, dy_nan, tc)
    assert bool(torch.isfinite(dxe).all()) and bool(torch.isfinite(dw).all())
    assert bool((dxe[dead.expand(e, c, d)] == 0).all())
    for i, n in enumerate(cnt):
        if n <= 0:
            assert bool((dw[i] == 0).all())
    assert torch.equal(dxe, ref.group_gemm_dxe_ref(tdy, tw, tc))
    assert torch.equal(dw, ref.group_gemm_dw_ref(tx, tdy, tc))
    for dtype in (torch.float32, torch.bfloat16):
        dy16 = ref.group_gemm_dy_ref(dy_nan, tc, dtype)
        assert dy16.dtype == dtype
        assert bool((dy16[dead.expand(e, c, f)] == 0).all())
        assert torch.equal(dy16[~dead.expand(e, c, f)],
                           tdy[~dead.expand(e, c, f)].to(dtype))


@pytest.mark.parametrize("c,d,f,counts,stages", [
    # moonshot's gate/up at a join: 8 x 11 tiles an expert
    (480, 2048, 1408, [0, 1, 64, 65, 480, 500, -3], [0, 1, 1, 2, 8, 8, 0]),
    # deepseek's gate/up at a join: C 160, 28 x 16 tiles an expert
    (160, 7168, 2048, [160, 100, 0, 63], [3, 2, 0, 1]),
    # ragged D and F: 2 x 2 tiles an expert
    (100, 264, 136, [100, 37, 0], [2, 1, 0])])
def test_dw_tile_counts(c, d, f, counts, stages):
    """The dw kernel's tiles, tiles of an empty expert and K stages, as
    its launch counts them on the card: ceil(D / 256) x ceil(F / 128)
    tiles an expert, each running ceil(count / 64) stages of K."""
    cnt = torch.tensor(counts, dtype=torch.int32)
    assert kernel.dw_stages(cnt, c).tolist() == stages
    per_expert = -(-d // kernel.BM_DW) * -(-f // kernel.BN_WGMMA)
    assert kernel.dw_tile_counts(cnt, c, d, f) == (
        len(counts) * per_expert,
        sum(s == 0 for s in stages) * per_expert,
        sum(stages) * per_expert)


@pytest.mark.parametrize("c,dtype,wgmma", [(480, torch.bfloat16, True),
                                           (17, torch.bfloat16, True),
                                           (16, torch.bfloat16, False),
                                           (480, torch.float32, False)])
def test_backward_route(c, dtype, wgmma):
    """bfloat16 past 16 rows takes the wgmma kernels (dxe's 256-row tiles
    and the dw kernel); the rest ``group_gemm.cu``'s tiles."""
    assert kernel.on_wgmma(c, dtype) is wgmma
    assert (kernel.tile_rows(c, dtype) == 256) is wgmma


def test_backward_wrappers_take_no_cpu_tensors():
    e, c, d, f = 2, 20, 8, 16
    cnt = torch.tensor([3, 0], dtype=torch.int32)
    xe = torch.zeros(e, c, d, dtype=torch.bfloat16)
    w = torch.zeros(e, d, f, dtype=torch.bfloat16)
    dy = torch.zeros(e, c, f)
    kernel.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        kernel.group_gemm_dy_cuda(dy, cnt, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.group_gemm_dxe_cuda(dy.to(torch.bfloat16), w, cnt)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.group_gemm_dw_cuda(xe, dy.to(torch.bfloat16), cnt)
    assert all(v == 0 for v in mg.launch_counts.values())
