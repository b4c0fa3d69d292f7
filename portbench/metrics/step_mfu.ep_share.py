"""The whole step's share of the chip's bfloat16 peak (%) for a
configuration that holds a share of the experts (``moe.experts_held`` of
``moe.n_experts``, one chip of an expert-parallel layer): ``step_mfu``'s
reading with each token's routed-expert work times held / E (the choices
this chip computes, under uniform routing).  Counted from the
configuration and the traffic; None for a configuration that holds every
expert."""
import dataclasses
import pathlib

from portbench import spec

BASE = spec._load(pathlib.Path(__file__).with_name("step_mfu.py"),
                  "portbench_metric_step_mfu")


def read(run):
    moe = run.cell.port.get("moe") or {}
    held, e = moe.get("experts_held", 0), moe.get("n_experts", 0)
    if not 0 < held < e:
        return None
    s = dataclasses.replace(run.shapes, top_k=run.shapes.top_k * held / e)
    return BASE.read(dataclasses.replace(run, shapes=s))
