"""The expert GEMM kernels' share of their roofline (%), over the traced
stretch: the bound of the work the traffic asks (each decode step's live
rows and each join's real prompt tokens through the routed experts, every
MoE layer; ``flops.group_gemm_work``) over the device time of the kernels
named below (the decode tiles and the bf16 join's wgmma kernel)."""
import portbench.flops as fl

KERNELS = ("group_gemm_kernel", "group_gemm_wgmma_kernel")


def read(run):
    if run.stretch is None or not run.shapes.n_experts:
        return None
    flops = nbytes = 0.0
    for rnd in run.stretch_rounds():
        joined, steps = run.round_work(rnd)
        calls = [len(step) for step in steps]
        if joined:
            calls.append(sum(joined))
        for rows in calls:
            f, b = fl.group_gemm_work(run.shapes, rows)
            flops, nbytes = flops + f, nbytes + b
    t = run.stretch.kernel_s(KERNELS)
    if t <= 0 or flops <= 0:
        return None
    return fl.share(fl.bound_s(flops, nbytes), t)
