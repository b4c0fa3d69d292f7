"""The paged prefill attention kernel's share of its roofline (%), over
the traced stretch: the bound of causal attention over each joined
prompt's real tokens (padding not counted; ``flops.paged_prefill_work``)
over the device time of the bf16 tensor-core prefill kernel."""
import portbench.flops as fl

KERNELS = ("prefill_tc_kernel",)


def read(run):
    if run.stretch is None:
        return None
    lengths = []
    for rnd in run.stretch_rounds():
        joined, _ = run.round_work(rnd)
        lengths += joined
    t = run.stretch.kernel_s(KERNELS)
    if t <= 0 or not lengths:
        return None
    return fl.share(fl.bound_s(*fl.paged_prefill_work(run.shapes, lengths)),
                    t)
