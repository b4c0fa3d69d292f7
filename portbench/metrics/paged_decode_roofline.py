"""The paged decode attention kernel's share of its roofline (%), over
the traced stretch: the bound of every live row's keys and values read
once a layer, q read and the output written (``flops.paged_decode_work``
at the context each row had at each step) over the kernel's device
time."""
import portbench.flops as fl

KERNELS = ("paged_decode_kernel",)


def read(run):
    if run.stretch is None:
        return None
    flops = nbytes = 0.0
    for rnd in run.stretch_rounds():
        _, steps = run.round_work(rnd)
        for step in steps:
            f, b = fl.paged_decode_work(run.shapes, step)
            flops, nbytes = flops + f, nbytes + b
    t = run.stretch.kernel_s(KERNELS)
    if t <= 0 or flops <= 0:
        return None
    return fl.share(fl.bound_s(flops, nbytes), t)
