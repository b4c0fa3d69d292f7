"""The expert GEMM kernels' share of their roofline (%), over the traced
stretch, for a configuration that holds a share of the experts
(``moe.experts_held`` = h of ``moe.n_experts`` = E, top-k):
``group_gemm_roofline``'s reading of the chip's share, the h held
experts, each chosen by a token k / E of the time under uniform routing
(``flops.group_gemm_work`` with h experts at top-k x h / E: rows x k x h
/ E pairs a call, h (1 - (1 - k/E)^rows) experts touched).  Counted from
the configuration and the traffic; None for a configuration that holds
every expert."""
import dataclasses
import pathlib

from portbench import spec

BASE = spec._load(pathlib.Path(__file__).with_name("group_gemm_roofline.py"),
                  "portbench_metric_group_gemm_roofline")


def read(run):
    moe = run.cell.port.get("moe") or {}
    held, e = moe.get("experts_held", 0), moe.get("n_experts", 0)
    if not 0 < held < e:
        return None
    s = dataclasses.replace(run.shapes, n_experts=held,
                            top_k=run.shapes.top_k * held / e)
    return BASE.read(dataclasses.replace(run, shapes=s))
