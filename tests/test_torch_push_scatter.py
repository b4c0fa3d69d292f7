"""Port push scatter vs the JAX package: the locality predictor
``hot_set`` (exactly, ties included), the kernel-level plain version
against the JAX Pallas kernel (interpret mode, as the JAX tests run it on
the CPU) at update counts that are whole 512-update tiles, and the op
against the JAX op at the cases of ``tests/test_kernels_push.py``.  On the
CPU the port's op runs the plain version; the CUDA kernel is held against
that same version on the card by ``tests/test_torch_cuda.py``.

Tolerances: the JAX test's (rtol = atol = 1e-4 for the op; 1e-5 where
every update is cold), and 1e-5 for the kernel-level comparison; both
sides sum the same float32 values in different orders."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.push_scatter import push_scatter as jax_push_scatter
from repro.kernels.push_scatter.kernel import push_scatter_kernel
from repro.kernels.push_scatter.ops import hot_set as jax_hot_set
from repro.kernels.push_scatter.ref import push_scatter_ref as jax_ref
from repro_torch.kernels import push_scatter as ps

torch.set_num_threads(1)


def _zipf(rng, n, u, alpha=1.1):
    pop = 1.0 / np.arange(1, n + 1) ** alpha
    return rng.choice(n, size=u, p=pop / pop.sum()).astype(np.int32)


@pytest.mark.parametrize("case", ["zipf", "uniform_counts", "partial_ties",
                                  "hot_above_nodes", "unvisited_nodes"])
def test_hot_set_matches_jax_exactly(case):
    """Slot per node equal to JAX's, ties included: ``lax.top_k`` puts the
    lower node first among equal counts, and so does the port's stable
    descending sort."""
    rng = np.random.default_rng(0)
    n, hot = 600, 128
    if case == "zipf":
        dst = _zipf(rng, n, 5000)
    elif case == "uniform_counts":      # every node updated 3 times
        dst = rng.permutation(np.repeat(np.arange(n), 3)).astype(np.int32)
    elif case == "partial_ties":        # few distinct counts, many ties
        dst = rng.integers(0, n, size=700).astype(np.int32)
    elif case == "hot_above_nodes":     # hot > n: every node gets a slot
        n, dst = 40, rng.integers(0, 40, size=300).astype(np.int32)
    else:                               # most nodes never updated
        dst = rng.integers(0, 50, size=400).astype(np.int32)
    got = ps.hot_set(torch.from_numpy(dst), n, hot)
    want = np.asarray(jax_hot_set(jnp.asarray(dst), n, hot))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("u,hot", [(512, 128), (2048, 1024), (3072, 256)])
def test_kernel_plain_version_matches_jax_kernel(u, hot):
    """(hot_acc, cold_vals) of the plain version and of the Pallas kernel
    on the same slots: hot, cold (-1), and a slot at or past ``hot``, which
    both drop."""
    rng = np.random.default_rng(u + hot)
    slots = rng.integers(-1, hot, size=u).astype(np.int32)
    slots[rng.random(u) < 0.3] = -1
    slots[::97] = hot + 5
    val = rng.standard_normal(u).astype(np.float32)
    hot_acc, cold = ps.push_scatter_kernel_ref(torch.from_numpy(slots),
                                               torch.from_numpy(val), hot)
    j_acc, j_cold = push_scatter_kernel(jnp.asarray(slots), jnp.asarray(val),
                                        hot=hot)
    assert hot_acc.shape == (hot,) and cold.shape == (u,)
    np.testing.assert_allclose(hot_acc.numpy(), np.asarray(j_acc)[0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cold.numpy(), np.asarray(j_cold)[0])


def _case(n, u, seed):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n).astype(np.float32)
    contrib = rng.standard_normal(u).astype(np.float32)
    return vals, contrib, _zipf(rng, n, u)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n,u,hot", [(100, 50, 16), (5000, 3000, 256),
                                     (512, 2048, 512), (64, 64, 64)])
def test_push_scatter_matches_jax(n, u, hot):
    vals, contrib, dst = _case(n, u, n + u)
    got = ps.push_scatter(*_t(vals, contrib, dst), hot=hot)
    want = jax_push_scatter(jnp.asarray(vals), jnp.asarray(contrib),
                            jnp.asarray(dst), hot=hot)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        ps.push_scatter_ref(*_t(vals, contrib, dst)).numpy(),
        np.asarray(jax_ref(jnp.asarray(vals), jnp.asarray(contrib),
                           jnp.asarray(dst))), rtol=1e-5, atol=1e-5)


def test_push_all_cold_matches_jax():
    """Every destination unique; the JAX test's case."""
    rng = np.random.default_rng(0)
    n = 4096
    vals = np.zeros(n, np.float32)
    contrib = rng.standard_normal(512).astype(np.float32)
    dst = rng.permutation(n)[:512].astype(np.int32)
    got = ps.push_scatter(*_t(vals, contrib, dst), hot=128)
    want = jax_push_scatter(jnp.asarray(vals), jnp.asarray(contrib),
                            jnp.asarray(dst), hot=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_push_all_hot_matches_jax():
    """One destination: the pure hot-accumulator path."""
    vals, contrib, dst = (np.zeros(256, np.float32),
                          np.ones(1024, np.float32),
                          np.zeros(1024, np.int32))
    got = ps.push_scatter(*_t(vals, contrib, dst), hot=128)
    want = jax_push_scatter(jnp.asarray(vals), jnp.asarray(contrib),
                            jnp.asarray(dst), hot=128)
    assert float(got[0]) == 1024.0 and bool((got[1:] == 0).all())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_take_the_plain_path_and_the_kernel_refuses_them():
    vals, contrib, dst = _case(300, 500, 1)
    before = dict(ps.launch_counts)
    ps.push_scatter(*_t(vals, contrib, dst), hot=64)
    assert ps.launch_counts == before
    slots = ps.hot_set(torch.from_numpy(dst), 300, 64)[torch.from_numpy(dst)]
    with pytest.raises(ValueError, match="CUDA"):
        ps.kernel.push_scatter_cuda(slots, torch.from_numpy(contrib), 64)
