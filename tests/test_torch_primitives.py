"""Port primitives vs the JAX package's ``repro.core.primitives``: the data
generators equal array for array (``make_skinny``, ``measured_sparsity``,
``Graph.trace_window``, ``Graph.edges``, ``paper_inputs``), so both packages
compute on the same inputs, and the oracles ``ss_gemm.reference`` and
``push.reference`` against the JAX ones at small sizes; then the slice as
a whole, a push iteration and a skinny product through the port's ops on
``paper_inputs`` / ``make_skinny`` data against the JAX oracles.

Tolerances: generators exactly; oracles and ops in float32, rtol = atol =
1e-5 (bfloat16 products 2e-2), both sides summing the same values in
different orders."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.primitives import graphs as jax_graphs
from repro.core.primitives import push as jax_push
from repro.core.primitives import ss_gemm as jax_ss_gemm
from repro_torch.core.primitives import graphs, push, ss_gemm
from repro_torch.kernels.push_scatter import push_scatter
from repro_torch.kernels.ss_gemm import ssgemm, ssgemm_compact

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("seed", [0, 3])
def test_make_skinny_and_sparsity_equal_jax(n, seed):
    prob = ss_gemm.Problem(k=512, n=n)
    assert dataclasses.asdict(prob) == dataclasses.asdict(
        jax_ss_gemm.Problem(k=512, n=n))
    got = ss_gemm.make_skinny(prob, seed)
    want = jax_ss_gemm.make_skinny(jax_ss_gemm.Problem(k=512, n=n), seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert ss_gemm.measured_sparsity(got) == jax_ss_gemm.measured_sparsity(
        want)


def test_problem_defaults_and_constants_equal_jax():
    assert dataclasses.asdict(ss_gemm.Problem()) == dataclasses.asdict(
        jax_ss_gemm.Problem())
    assert ss_gemm.ELEM_BYTES == jax_ss_gemm.ELEM_BYTES
    for name in ("VALUE_BYTES", "PROP_BYTES", "INDEX_BYTES", "COLD_ROW_HIT",
                 "HOT_ROW_HIT"):
        assert getattr(push, name) == getattr(jax_push, name)


def test_paper_inputs_equal_jax():
    """Names, sizes and hit rates, and a window and an edge list of each
    graph (two window seeds), array for array."""
    got, want = graphs.paper_inputs(seed=1), jax_graphs.paper_inputs(seed=1)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g.name, g.n_nodes, g.n_edges, g.measured_l2_hit) == (
            w.name, w.n_nodes, w.n_edges, w.measured_l2_hit)
        for wseed in (0, 5):
            np.testing.assert_array_equal(g.trace_window(3000, wseed),
                                          w.trace_window(3000, wseed))
            for a, b in zip(g.edges(2500, wseed), w.edges(2500, wseed)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("make", [
    lambda m: m.powerlaw(5000, 40_000, alpha=1.2, seed=4),
    lambda m: m.powerlaw(3000, 9000, alpha=1.0, seed=2),
    lambda m: m.roadnet(8000, avg_degree=3.1, far_frac=0.2, seed=6)])
def test_generators_equal_jax(make):
    g, w = make(graphs), make(jax_graphs)
    np.testing.assert_array_equal(g.trace_window(4000, 2),
                                  w.trace_window(4000, 2))
    for a, b in zip(g.edges(1777, 3), w.edges(1777, 3)):
        np.testing.assert_array_equal(a, b)


def test_ss_gemm_reference_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((96, 300)).astype(np.float32)
    b = ss_gemm.make_skinny(ss_gemm.Problem(k=300, n=4), 1)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, TOL),
                          (jnp.bfloat16, torch.bfloat16,
                           dict(rtol=2e-2, atol=2e-2))):
        got = ss_gemm.reference(torch.from_numpy(a).to(tdt),
                                torch.from_numpy(b).to(tdt))
        want = jax_ss_gemm.reference(jnp.asarray(a, jdt), jnp.asarray(b, jdt))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_push_reference_matches_jax():
    g = graphs.powerlaw(2000, 20_000, alpha=0.6, seed=3)
    src, dst = g.edges(20_000, 0)
    vals = np.random.default_rng(1).standard_normal(2000).astype(np.float32)
    got = push.reference(torch.from_numpy(vals), torch.from_numpy(src),
                         torch.from_numpy(dst), 2000)
    want = jax_push.reference(jnp.asarray(vals), jnp.asarray(src),
                              jnp.asarray(dst), 2000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("graph", ["roadnet-usa", "powerlaw-1M-10M",
                                   "powerlaw-10M-100M"])
def test_push_iteration_through_the_port_matches_jax(graph):
    """The slice's push path on a window of each paper input: the port's
    ``push_scatter`` on 0.85 x values[src] against the JAX oracle."""
    g = {x.name: x for x in graphs.paper_inputs(0)}[graph]
    n = 50_000                      # nodes of the window's neighbourhood
    src, dst = g.edges(20_000, 0)
    src, dst = src % n, dst % n
    vals = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    tv = torch.from_numpy(vals)
    got = push_scatter(tv, 0.85 * tv[torch.from_numpy(src)],
                       torch.from_numpy(dst))
    want = jax_push.reference(jnp.asarray(vals), jnp.asarray(src),
                              jnp.asarray(dst), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n", [2, 16])
def test_skinny_product_through_the_port_matches_jax(n):
    """The slice's ss-gemm path on ``make_skinny`` data (K 1,024, bf16):
    dense, masked and compact (at the live count and half of it) against
    the JAX oracle."""
    prob = ss_gemm.Problem(m=128, k=1024, n=n)
    b = ss_gemm.make_skinny(prob, 0)
    a = np.random.default_rng(n).standard_normal((128, 1024)).astype(
        np.float32)
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    want = np.asarray(jax_ss_gemm.reference(jnp.asarray(a, jnp.bfloat16),
                                            jnp.asarray(b, jnp.bfloat16)))
    live = 4                          # 1,024 / 256: every block is live
    for got in (ssgemm(ta, tb, sparsity_aware=False), ssgemm(ta, tb),
                ssgemm_compact(ta, tb, budget=live),
                ssgemm_compact(ta, tb, budget=live // 2)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
