"""The open-loop cells' whole step: its share of the chip's bfloat16 peak
(%), the model operations of every prompt and output token the device
processed in the window (2 x active parameters a token, causal attention,
each read-out) over the window's seconds times 989 TFLOP/s; it bounds the
join and decode kernels behind the time to first token."""
import portbench.flops as fl


def read(run):
    work = run.model_flops()
    if work <= 0:
        return None
    return 100.0 * work / (run.window_s * fl.PEAK_FLOPS_BF16)
