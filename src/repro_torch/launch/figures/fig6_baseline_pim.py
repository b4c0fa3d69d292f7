"""Figure 6: commercial PIM speedup relative to GPU (baseline PIM).

From ``benchmarks/fig6_baseline_pim.py``: the paper's model
(its simulated PIM and GPU), host arithmetic equal to the JAX
package's; no number here is a measurement of the card.

Paper observations reproduced here:
  * vector-sum attains over 2.6x;
  * primitives under study land between ~0.23x and ~1.66x;
  * ss-gemm slows down increasingly with N; push degrades as L2 hit grows.
"""
from __future__ import annotations

from ...core.hwspec import DEFAULT_GPU as GPU, DEFAULT_PIM as PIM
from ...core.primitives import push, ss_gemm, vector_sum, wavesim
from ...core.primitives.graphs import paper_inputs

from .common import Table

SS_GEMM_N = (2, 4, 8, 16)


def run(table: Table | None = None) -> dict[str, float]:
    t = table or Table("Fig 6 — baseline PIM speedup vs GPU")
    out: dict[str, float] = {}

    vp = vector_sum.Problem(n=64 * 1024 * 1024)
    st = vector_sum.pim_time(vp, PIM)
    s = vector_sum.speedup(vp, PIM, GPU)
    out["vector-sum"] = s
    t.anchor("vector-sum", s, ">2.6", time_ns=st.time_ns)

    wp = wavesim.Problem()
    sv = wavesim.speedup_volume(wp, PIM, GPU)
    out["wavesim-volume"] = sv
    t.anchor("wavesim-volume", sv, 1.5,
             time_ns=wavesim.pim_time_volume(wp, PIM).time_ns)
    sf = wavesim.speedup_flux(wp, PIM, GPU)
    out["wavesim-flux"] = sf
    t.anchor("wavesim-flux", sf, "flux baseline (Fig 8 leftmost)",
             time_ns=wavesim.pim_time_flux(wp, PIM).time_ns)

    paper_base = {2: 1.66, 4: 0.75, 8: 0.43, 16: 0.23}
    for n in SS_GEMM_N:
        sp = ss_gemm.Problem(n=n)
        r = ss_gemm.speedups(sp, PIM, GPU)
        out[f"ss-gemm-N{n}"] = r["baseline"]
        t.anchor(f"ss-gemm-N{n}", r["baseline"], paper_base[n],
                 time_ns=ss_gemm.pim_time(sp, PIM).time_ns)

    for g in paper_inputs():
        r = push.evaluate(g, PIM, GPU)
        out[f"push[{g.name}]"] = r.speedup_baseline
        t.anchor(f"push[{g.name}] L2-HR~{g.measured_l2_hit:.0%}",
                 r.speedup_baseline, "<1 (degradation)",
                 time_ns=r.pim_baseline_ns)

    if table is None:
        t.emit()
    return out


if __name__ == "__main__":
    run()
