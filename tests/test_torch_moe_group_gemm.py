"""The port's grouped expert GEMM op against the JAX op on the same numpy
inputs.  The JAX side runs as its own tests run it on the CPU: the Pallas
kernel in interpret mode (``tests/test_kernels_moe.py``); the port's CPU
route is the plain version.

Cases: the (E, C, D, F) sweep of ``test_kernels_moe.py`` in float32
(rtol 1e-4, atol 1e-3, as there) and bfloat16 (rtol 5e-2, atol 0.5, as
there), the JAX op at ``bc`` 64 (the port's op takes no ``bc``); empty
and full experts, whose padded rows must be exactly zero; a ragged C that
the JAX op pads to its tile, with counts past C; the ``bc`` 8 case of
``test_moe_dispatch.py``'s agreement test on the reduced moonshot expert
weights, bridged; and the routing, tiling arithmetic and argument checks
of the port's wrapper."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.moe_group_gemm import group_gemm as jax_group_gemm
from repro.models import param as pm
from repro.models.moe import init_moe
from repro_torch.kernels import moe_group_gemm as mg
from repro_torch.kernels.moe_group_gemm import kernel
from repro_torch.models.bridge import params_from_numpy

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-1)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rng, e, c, d, f, counts, name):
    jdt, tdt = DTYPES[name]
    xe = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    cnt = np.asarray(counts, np.int32)
    jax_args = (jnp.asarray(xe, jdt), jnp.asarray(w, jdt), jnp.asarray(cnt))
    port_args = (torch.from_numpy(xe).to(tdt), torch.from_numpy(w).to(tdt),
                 torch.from_numpy(cnt))
    return jax_args, port_args


@pytest.mark.parametrize("e,c,d,f", [(2, 128, 64, 64), (8, 256, 128, 96),
                                     (4, 64, 32, 256)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_group_gemm_matches_jax(e, c, d, f, name):
    rng = np.random.default_rng(e * c)
    counts = rng.integers(0, c + 1, size=e)
    (jx, jw, jc), (tx, tw, tc) = _inputs(rng, e, c, d, f, counts, name)
    want = np.asarray(jax_group_gemm(jx, jw, jc, bc=64), np.float32)
    got = mg.group_gemm(tx, tw, tc)
    assert got.dtype == torch.float32 and got.shape == (e, c, f)
    np.testing.assert_allclose(got.numpy(), want, **TOL[name])
    live = np.arange(c)[None, :, None] < counts[:, None, None]
    assert (got.numpy()[~np.broadcast_to(live, got.shape)] == 0).all()


@pytest.mark.parametrize("counts", [[0, 128, 0, 5], [0, 0, 0, 0],
                                    [128, 128, 128, 128]])
def test_empty_and_full_experts(counts):
    """Empty experts and the rows past a count are exact zeros; full
    experts match JAX on every row."""
    rng = np.random.default_rng(0)
    (jx, jw, jc), (tx, tw, tc) = _inputs(rng, 4, 128, 32, 64, counts,
                                         "float32")
    got = mg.group_gemm(tx, tw, tc)
    for i, n in enumerate(counts):
        assert (got[i, n:] == 0).all()
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_group_gemm(jx, jw, jc, bc=64)),
                               **TOL["float32"])


@pytest.mark.parametrize("bc", [64, 128])
def test_ragged_capacity(bc):
    """C = 100 is a multiple of neither tile: the JAX op pads it and crops;
    the port takes it as it is.  A count past C means every row."""
    rng = np.random.default_rng(bc)
    counts = [100, 37, 0, 64, 103]
    (jx, jw, jc), (tx, tw, tc) = _inputs(rng, 5, 100, 48, 80, counts,
                                         "float32")
    got = mg.group_gemm(tx, tw, tc)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_group_gemm(jx, jw, jc, bc=bc)),
                               **TOL["float32"])
    assert (got[1, 37:] == 0).all() and (got[2] == 0).all()


def test_agrees_with_moe_expert_compute_on_bridged_weights():
    """``test_moe_dispatch.py``'s agreement case: reduced moonshot expert
    weights (``init_moe``), through the bridge, C 16, ``bc`` 8."""
    cfg = jax_get_config("moonshot-v1-16b-a3b").reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, pm.unwrap(init_moe(jax.random.key(0), cfg)))
    wi = params_from_numpy(tree, device="cpu")["wi"]
    rng = np.random.default_rng(2)
    e, c, d = cfg.moe.n_experts, 16, cfg.d_model
    xe = rng.standard_normal((e, c, d)).astype(np.float32)
    counts = rng.integers(0, c + 1, e).astype(np.int32)
    want = jax_group_gemm(jnp.asarray(xe), jnp.asarray(tree["wi"]),
                          jnp.asarray(counts), bc=8)
    got = mg.group_gemm(torch.from_numpy(xe), wi, torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    _, (tx, tw, tc) = _inputs(rng, 3, 20, 16, 24, [20, 3, 0], "float32")
    kernel.reset_launch_counts()
    got = mg.group_gemm(tx, tw, tc)
    assert kernel.launch_counts == {"group_gemm": 0, "group_gemm_dy": 0,
                                    "group_gemm_dxe": 0, "group_gemm_dw": 0}
    assert torch.equal(got, mg.group_gemm_ref(tx, tw, tc))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.group_gemm_cuda(tx, tw, tc)       # the wrapper takes no CPU


@pytest.mark.parametrize("c,dtype,counts,rows", [
    (1, torch.bfloat16, [1, 0, 1, 0], (4, 2)),     # decode: C 1, tiles of 16
    (480, torch.bfloat16, [480, 0, 100, 64],       # a join: the wgmma
     (4 * 2, 0 + 2 + 1 + 1)),                      # kernel's 256-row tiles
    (480, torch.float32, [480, 0, 100, 64],        # float32: 64-row tiles
     (4 * 8, 0 + 8 + 6 + 7)),
    (16, torch.bfloat16, [17, -2], (2, 1))])       # counts clamp to [0, C]
def test_tile_counts(c, dtype, counts, rows):
    """Tiles of the kernel's launch and those skipped: ``rows`` gives them
    per column tile (16-row tiles up to C 16, then 256-row tiles in
    bfloat16 and 64-row tiles in float32), times F 1408's column tiles of
    ``kernel.BN_WGMMA`` (the bfloat16 kernel past C 16) or ``kernel.BN``."""
    bn = kernel.BN_WGMMA if c > 16 and dtype == torch.bfloat16 else kernel.BN
    assert kernel.tile_cols(c, dtype) == bn
    n_f = -(-1408 // bn)
    assert (kernel.tile_counts(torch.tensor(counts), c, 1408, dtype)
            == (rows[0] * n_f, rows[1] * n_f))


def test_argument_checks():
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="E, C, D"):
        mg.group_gemm(x, torch.zeros(2, 7, 3), torch.zeros(2))
    with pytest.raises(ValueError, match="E, C, D"):
        mg.group_gemm(x[0], torch.zeros(8, 3), torch.zeros(2))
