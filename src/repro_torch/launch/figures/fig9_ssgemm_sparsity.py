"""Figure 9: optimized PIM speedup for ss-gemm (sparsity-aware PIM, §5.1.2).

From ``benchmarks/fig9_ssgemm_sparsity.py``: the paper's model
(its simulated PIM and GPU), host arithmetic equal to the JAX
package's; no number here is a measurement of the card.

Paper anchors: sparsity-aware PIM lifts speedup above 3x for the skinniest
case and turns the N=8 slowdown (0.43x) into a 1.07x speedup.  Benefits
taper as N (GPU reuse) increases.
"""
from __future__ import annotations

from ...core.hwspec import DEFAULT_GPU as GPU, DEFAULT_PIM as PIM
from ...core.primitives import ss_gemm

from .common import Table
from .fig6_baseline_pim import SS_GEMM_N


def run(table: Table | None = None) -> dict[str, float]:
    t = table or Table("Fig 9 — ss-gemm: sparsity-aware PIM")
    out: dict[str, float] = {}
    anchors = {2: ">3", 8: 1.07}
    for n in SS_GEMM_N:
        sp = ss_gemm.Problem(n=n)
        r = ss_gemm.speedups(sp, PIM, GPU)
        st = ss_gemm.pim_time(sp, PIM, sparsity_aware=True,
                              density=r["density"])
        name = f"ss-gemm-N{n} sparsity-aware"
        out[name] = r["sparsity_aware"]
        paper = anchors.get(n)
        if paper is not None:
            t.anchor(name, r["sparsity_aware"], paper, time_ns=st.time_ns)
        else:
            t.add(name, st.time_ns,
                  f"{r['sparsity_aware']:.2f}x (element density "
                  f"{r['density']:.2f}, row-zero {r['row_zero_frac']:.2f})")
    if table is None:
        t.emit()
    return out


if __name__ == "__main__":
    run()
