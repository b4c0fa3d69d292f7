"""Quick calibration check of the analytical model vs paper anchors, from
``scripts/calibrate.py``: the same lines, host arithmetic equal to the JAX
package's (the paper's simulated PIM and GPU, not the card).

  PYTHONPATH=src python -m repro_torch.launch.calibrate
"""
from __future__ import annotations

from ..core.hwspec import DEFAULT_GPU as GPU, DEFAULT_PIM as PIM, PimSpec
from ..core.primitives import push, ss_gemm, vector_sum, wavesim
from ..core.primitives.graphs import paper_inputs


def main() -> None:
    print("== spec sanity ==")
    print(f"peak hbm: {PIM.regular_bytes_per_ns_per_pch * PIM.pch_per_stack:.1f} GB/s (want 614.4)")
    print(f"pim bw:   {PIM.pim_peak_gbps:.1f} GB/s (want ~2457.6, 4x)")
    print(f"upper bound vs 90%-GPU: {PIM.pim_peak_gbps / GPU.effective_gbps:.2f}x")

    print("\n== vector-sum (paper: >2.6x) ==")
    p = vector_sum.Problem(n=64 * 1024 * 1024)
    st = vector_sum.pim_time(p, PIM)
    print(f"baseline: {vector_sum.speedup(p, PIM, GPU):.2f}x  act_frac={st.act_stall_frac:.2%}")
    print(f"arch-aware: {vector_sum.speedup(p, PIM, GPU, arch_aware=True):.2f}x")

    print("\n== wavesim (paper: volume 1.5x->2.04x, act 27%; flux act 50%, 64regs->2.63x) ==")
    wp = wavesim.Problem()
    for regs in (16, 32, 64):
        sv = wavesim.pim_time_volume(wp, PIM, regs=regs)
        sva = wavesim.speedup_volume(wp, PIM, GPU, regs=regs)
        svo = wavesim.speedup_volume(wp, PIM, GPU, arch_aware=True, regs=regs)
        print(f"volume r{regs}: base {sva:.2f}x (act {sv.act_stall_frac:.1%}) arch-aware {svo:.2f}x")
    for regs in (16, 32, 64):
        sf = wavesim.pim_time_flux(wp, PIM, regs=regs)
        sfa = wavesim.speedup_flux(wp, PIM, GPU, regs=regs)
        sfo = wavesim.speedup_flux(wp, PIM, GPU, arch_aware=True, regs=regs)
        print(f"flux   r{regs}: base {sfa:.2f}x (act {sf.act_stall_frac:.1%}) arch-aware {sfo:.2f}x")

    print("\n== ss-gemm (paper: base {1.66,0.75,0.43,0.23}; sa {>3,...,1.07@N8}) ==")
    for n in (2, 4, 8, 16):
        sp = ss_gemm.Problem(n=n)
        r = ss_gemm.speedups(sp, PIM, GPU)
        print(f"N={n:2d}: base {r['baseline']:.2f}x  sparsity-aware {r['sparsity_aware']:.2f}x "
              f"(density {r['density']:.2f}, row-zero {r['row_zero_frac']:.2f})")

    print("\n== push (paper: ca avg 1.20x max 1.39x; ca-GPU up to 1.68x; 4x cmdBW up to 2.02x) ==")
    for g in paper_inputs():
        r = push.evaluate(g, PIM, GPU)
        pim4 = PimSpec(command_bw_mult=4.0)
        cold = int(g.n_edges * (1.0 - r.predictor_hit_rate))
        t4 = push.pim_time(g, pim4, n_updates=max(1, cold),
                           row_hit_frac=push.COLD_ROW_HIT).time_ns
        feed = push.gpu_feed_time_ns(g, GPU)
        t4 = max(t4, feed) + 0.15 * min(t4, feed)
        print(f"{g.name:22s} h_meas={g.measured_l2_hit:.2f} h_pred={r.predictor_hit_rate:.2f} "
              f"base {r.speedup_baseline:.2f}x ca {r.speedup_cache_aware:.2f}x "
              f"caGPU {r.speedup_gpu_cache_aware:.2f}x ca+4xBW {r.gpu_ns / t4:.2f}x")


if __name__ == "__main__":
    main()
