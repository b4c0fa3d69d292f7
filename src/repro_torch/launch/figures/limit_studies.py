"""§5.1.4 limit studies: PIM register count and command bandwidth swept
across the primitives they gate (beyond the two points Figures 8/10 show).

From ``benchmarks/limit_studies.py``: the paper's model
(its simulated PIM and GPU), host arithmetic equal to the JAX
package's; no number here is a measurement of the card.

Registers gate broadcast primitives (chunk length amortizes activations);
command bandwidth gates single-bank primitives (push).  The table shows
where each primitive saturates — the "careful attention to these
decisions" argument of §5.1.4 made quantitative.
"""
from __future__ import annotations

import dataclasses

from ...core.hwspec import DEFAULT_GPU as GPU, DEFAULT_PIM as PIM
from ...core.primitives import push, vector_sum, wavesim
from ...core.primitives.graphs import powerlaw

from .common import Table

REGS = (8, 16, 32, 64, 128)
CMD_BW = (1.0, 2.0, 4.0, 8.0)


def run(table: Table | None = None) -> dict[str, float]:
    t = table or Table("Limit studies — registers x command bandwidth")
    out: dict[str, float] = {}
    wp = wavesim.Problem()
    vp = vector_sum.Problem(n=64 << 20)
    for regs in REGS:
        sv = wavesim.speedup_volume(wp, PIM, GPU, arch_aware=True, regs=regs)
        sf = wavesim.speedup_flux(wp, PIM, GPU, arch_aware=True, regs=regs)
        vs = vector_sum.speedup(vp, PIM, GPU, arch_aware=True, regs=regs)
        out[f"regs{regs}"] = sf
        t.add(f"registers={regs} (arch-aware)", 0.0,
              f"volume {sv:.2f}x | flux {sf:.2f}x | vector-sum {vs:.2f}x")
    # saturation point for flux (the register-hungry primitive)
    gains = [out[f"regs{r}"] for r in REGS]
    sat = next((REGS[i] for i in range(1, len(gains))
                if gains[i] / gains[i - 1] < 1.05), REGS[-1])
    t.add("flux register saturation", 0.0,
          f"{sat} registers (<5% marginal gain beyond)")

    g = powerlaw(1_000_000, 10_000_000, alpha=0.6,
                 name="powerlaw-1M-10M", measured_l2_hit=0.20)
    r = push.evaluate(g, PIM, GPU, predictor_sample=120_000)
    cold = int(g.n_edges * (1.0 - r.predictor_hit_rate))
    feed = push.gpu_feed_time_ns(g, GPU)
    for bw in CMD_BW:
        pimx = dataclasses.replace(PIM, command_bw_mult=bw)
        tc = push.pim_time(g, pimx, n_updates=max(1, cold),
                           row_hit_frac=push.COLD_ROW_HIT).time_ns
        tc = max(tc, feed) + 0.15 * min(tc, feed)
        s = r.gpu_ns / tc
        out[f"cmdbw{bw}"] = s
        t.add(f"push cache-aware, command-BW x{bw:.0f}", tc, f"{s:.2f}x")
    t.add("push command-BW saturation", 0.0,
          "beyond 4x the data bus / activation throughput binds "
          f"(x4 -> x8 gain: {out['cmdbw8.0'] / out['cmdbw4.0']:.2f}x)")
    if table is None:
        t.emit()
    return out


if __name__ == "__main__":
    run()
