"""Headline claim: average PIM speedup 1.12x (baseline) -> 2.49x (optimized).

From ``benchmarks/headline.py``: the paper's model
(its simulated PIM and GPU), host arithmetic equal to the JAX
package's; no number here is a measurement of the card.

The averaging set is the primitives under study with each primitive's
*targeted* optimization (§5.2): wavesim with architecture-aware activation
(+64 registers for flux), ss-gemm with sparsity-aware PIM, push with
cache-aware PIM + 4x command bandwidth.  vector-sum (the known-amenable
comparison point) is reported both in and out of the average since the
paper's set is not itemized.
"""
from __future__ import annotations

import dataclasses

from ...core.hwspec import DEFAULT_GPU as GPU, DEFAULT_PIM as PIM
from ...core.primitives import push, ss_gemm, vector_sum, wavesim
from ...core.primitives.graphs import paper_inputs

from .common import Table
from .fig6_baseline_pim import SS_GEMM_N


def run(table: Table | None = None) -> dict[str, float]:
    t = table or Table("Headline — average PIM speedup, baseline vs optimized")
    base: dict[str, float] = {}
    opt: dict[str, float] = {}

    wp = wavesim.Problem()
    base["wavesim-volume"] = wavesim.speedup_volume(wp, PIM, GPU)
    opt["wavesim-volume"] = wavesim.speedup_volume(wp, PIM, GPU,
                                                   arch_aware=True)
    base["wavesim-flux"] = wavesim.speedup_flux(wp, PIM, GPU)
    opt["wavesim-flux"] = wavesim.speedup_flux(wp, PIM, GPU, arch_aware=True,
                                               regs=64)
    for n in SS_GEMM_N:
        sp = ss_gemm.Problem(n=n)
        r = ss_gemm.speedups(sp, PIM, GPU)
        base[f"ss-gemm-N{n}"] = r["baseline"]
        opt[f"ss-gemm-N{n}"] = r["sparsity_aware"]
    pim4 = dataclasses.replace(PIM, command_bw_mult=4.0)
    for g in paper_inputs():
        r = push.evaluate(g, PIM, GPU)
        base[f"push[{g.name}]"] = r.speedup_baseline
        cold = int(g.n_edges * (1.0 - r.predictor_hit_rate))
        t4 = push.pim_time(g, pim4, n_updates=max(1, cold),
                           row_hit_frac=push.COLD_ROW_HIT).time_ns
        feed = push.gpu_feed_time_ns(g, GPU)
        t4 = max(t4, feed) + 0.15 * min(t4, feed)
        opt[f"push[{g.name}]"] = r.gpu_ns / t4

    vb = vector_sum.speedup(vector_sum.Problem(n=64 * 1024 * 1024), PIM, GPU)
    vo = vector_sum.speedup(vector_sum.Problem(n=64 * 1024 * 1024), PIM, GPU,
                            arch_aware=True)

    avg_b = sum(base.values()) / len(base)
    avg_o = sum(opt.values()) / len(opt)
    avg_b_v = (sum(base.values()) + vb) / (len(base) + 1)
    avg_o_v = (sum(opt.values()) + vo) / (len(opt) + 1)
    t.anchor("average baseline (studied primitives)", avg_b, 1.12)
    t.anchor("average optimized (studied primitives)", avg_o, 2.49)
    t.add("average baseline (incl vector-sum)", 0.0, f"{avg_b_v:.2f}x")
    t.add("average optimized (incl vector-sum)", 0.0, f"{avg_o_v:.2f}x")
    t.add("improvement ratio", 0.0,
          f"{avg_o / avg_b:.2f}x (paper 2.49/1.12 = 2.22x)")
    if table is None:
        t.emit()
    return {"avg_baseline": avg_b, "avg_optimized": avg_o}


if __name__ == "__main__":
    run()
