"""Figure 10: optimized PIM speedup for push-primitive.

From ``benchmarks/fig10_push_cacheaware.py``: the paper's model
(its simulated PIM and GPU), host arithmetic equal to the JAX
package's; no number here is a measurement of the card.

Cache-aware PIM (§5.1.3) + the command-bandwidth limit study (§5.1.4).
Paper anchors: cache-aware PIM avg 1.20x / max 1.39x; cache-aware GPU up to
1.68x; with 4x command bandwidth PIM exceeds cache-aware GPU for all inputs,
up to 2.02x.
"""
from __future__ import annotations

import dataclasses

from ...core.hwspec import DEFAULT_GPU as GPU, DEFAULT_PIM as PIM
from ...core.primitives import push
from ...core.primitives.graphs import paper_inputs

from .common import Table


def run(table: Table | None = None) -> dict[str, float]:
    t = table or Table("Fig 10 — push: cache-aware PIM + command bandwidth")
    out: dict[str, float] = {}
    ca, ca4 = [], []
    for g in paper_inputs():
        r = push.evaluate(g, PIM, GPU)
        pim4 = dataclasses.replace(PIM, command_bw_mult=4.0)
        cold = int(g.n_edges * (1.0 - r.predictor_hit_rate))
        t4 = push.pim_time(g, pim4, n_updates=max(1, cold),
                           row_hit_frac=push.COLD_ROW_HIT).time_ns
        feed = push.gpu_feed_time_ns(g, GPU)
        t4 = max(t4, feed) + 0.15 * min(t4, feed)
        s4 = r.gpu_ns / t4
        label = f"push[{g.name}]"
        out[f"{label} cache-aware"] = r.speedup_cache_aware
        out[f"{label} cache-aware-gpu"] = r.speedup_gpu_cache_aware
        out[f"{label} cache-aware+4xBW"] = s4
        ca.append(r.speedup_cache_aware)
        ca4.append(s4)
        t.add(f"{label} cache-aware PIM", r.pim_cache_aware_ns,
              f"{r.speedup_cache_aware:.2f}x (pred-hit "
              f"{r.predictor_hit_rate:.0%})")
        t.add(f"{label} cache-aware GPU", r.gpu_cache_aware_ns,
              f"{r.speedup_gpu_cache_aware:.2f}x")
        t.add(f"{label} cache-aware PIM + 4x cmd-BW", t4, f"{s4:.2f}x")
    t.anchor("cache-aware PIM average", sum(ca) / len(ca), 1.20)
    t.anchor("cache-aware PIM max", max(ca), 1.39)
    t.anchor("cache-aware+4xBW max", max(ca4), 2.02)
    if table is None:
        t.emit()
    return out


if __name__ == "__main__":
    run()
