"""Figure 8: optimized PIM speedup for wavesim primitives.

From ``benchmarks/fig8_wavesim_opt.py``: the paper's model
(its simulated PIM and GPU), host arithmetic equal to the JAX
package's; no number here is a measurement of the card.

Architecture-aware row activation (§5.1.1) x register limit study (§5.1.4).
Paper anchors: volume 1.5x -> 2.04x with arch-aware (activation overhead
eliminated; more registers don't help further); flux shows no arch-aware
benefit at 16 registers but reaches up to 2.63x at 64.
"""
from __future__ import annotations

from ...core.hwspec import DEFAULT_GPU as GPU, DEFAULT_PIM as PIM
from ...core.primitives import wavesim

from .common import Table

REGS = (16, 32, 64)


def run(table: Table | None = None) -> dict[str, float]:
    t = table or Table("Fig 8 — wavesim: arch-aware activation x registers")
    out: dict[str, float] = {}
    wp = wavesim.Problem()
    anchors = {("volume", 16, True): 2.04, ("flux", 64, True): 2.63}
    for prim, speedup_fn, time_fn in (
            ("volume", wavesim.speedup_volume, wavesim.pim_time_volume),
            ("flux", wavesim.speedup_flux, wavesim.pim_time_flux)):
        for regs in REGS:
            for aa in (False, True):
                s = speedup_fn(wp, PIM, GPU, arch_aware=aa, regs=regs)
                st = time_fn(wp, PIM, arch_aware=aa, regs=regs)
                name = f"wavesim-{prim} regs={regs} {'arch-aware' if aa else 'baseline'}"
                out[name] = s
                paper = anchors.get((prim, regs, aa))
                if paper is not None:
                    t.anchor(name, s, paper, time_ns=st.time_ns)
                else:
                    t.add(name, st.time_ns,
                          f"{s:.2f}x (act-stall {st.act_stall_frac:.0%})")
    if table is None:
        t.emit()
    return out


if __name__ == "__main__":
    run()
