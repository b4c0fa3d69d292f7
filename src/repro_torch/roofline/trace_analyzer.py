"""Per-device FLOP, collective and memory accounting of an eager trace:
the port's counterpart of :mod:`repro.roofline.hlo_analyzer`, which reads
XLA's optimized HLO text.

:class:`TraceAnalyzer` is a ``TorchDispatchMode`` over one step run on a
mesh (the dry-run runs it on fake tensors in a fake world).  A DTensor op
is passed on to DTensor (``NotImplemented``), so the mode sees the local
ops each rank runs, its collectives included, whether the port's code or
DTensor's redistribution issued them: the per-device program, as the
post-SPMD HLO is.  Eager tracing runs every loop (layers, microbatches,
chunks), so no trip-count correction is needed.

Accounting conventions (JAX's, for the roofline):

* dot flops = 2 x prod(result dims) x prod(contracted dims), over
  ``mm``, ``addmm``, ``bmm``, ``baddbmm`` (einsum lowers to these);
* collective bytes = result-shape bytes (all-gather: the gathered shape;
  all-reduce: the payload once; reduce-scatter: the operand, result x
  group size; all-to-all: the result), by JAX's kinds;
* elementwise flops are ignored (dots dominate every cell);
* ``peak_temp_bytes``: the most bytes that ops of the step held at once,
  counted at each non-view output and released when it is freed (the
  fake mode's tensors are freed as real ones are; a candidate peak is
  taken after a garbage collection, so that tensors held only by
  reference cycles do not count).
"""
from __future__ import annotations

import dataclasses
import gc
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (an OpOverloadPacket's) -> JAX's collective kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out":
    "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_DOTS = ("mm", "addmm", "bmm", "baddbmm")


def _nbytes(t) -> float:
    return float(t.numel() * t.element_size())


@dataclasses.dataclass
class TraceStats:
    flops: float = 0.0            # dot FLOPs: the only FLOPs counted
    dot_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_calls: dict = dataclasses.field(default_factory=dict)
    n_ops: int = 0
    peak_temp_bytes: float = 0.0

    def as_dict(self) -> dict:
        """The keys :mod:`repro_torch.roofline.analysis` reads, JAX's
        ``HloStats.as_dict`` names where they exist."""
        return {"flops": self.flops,
                "dot_bytes": self.dot_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_calls": dict(self.collective_calls),
                "n_ops": self.n_ops,
                "peak_temp_bytes": self.peak_temp_bytes}


def dot_flops(name: str, args, out) -> float:
    """2 x result elements x contracted length of a dot op."""
    if name in ("mm", "bmm"):
        k = args[0].shape[-1]
    else:                                   # addmm / baddbmm: (bias, a, b)
        k = args[1].shape[-1]
    return 2.0 * out.numel() * k


class TraceAnalyzer(TorchDispatchMode):
    """Count dots, collectives and live bytes of the local ops run inside
    it (see the module docstring).  ``stats`` holds the totals.  The ops
    DTensor runs on global-shaped fakes to propagate shapes do not
    count (its ``ShardingPropagator`` is wrapped while the mode is
    active)."""

    def __init__(self):
        super().__init__()
        self.stats = TraceStats()
        self._live = 0.0
        self._paused = 0

    def __enter__(self):
        # DTensor derives an op's global output shape by running the op on
        # global-shaped fake tensors; that run is not the rank's program
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def paused(prop, op_schema):
            self._paused += 1
            try:
                return orig(prop, op_schema)
            finally:
                self._paused -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        self._restore = (ShardingPropagator, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, orig = self._restore
        cls._propagate_tensor_meta_non_cached = orig
        return super().__exit__(*exc)

    def _free(self, n: float) -> None:
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if self._paused:
            return out    # DTensor's shape propagation, not the step
        st = self.stats
        st.n_ops += 1
        name = func._overloadpacket.__name__
        if name in _DOTS:
            st.flops += dot_flops(name, args, out)
            st.dot_bytes += sum(_nbytes(a) for a in args
                                if isinstance(a, torch.Tensor)) + _nbytes(out)
        kind = _KINDS.get(name)
        if kind is not None:
            res = out
            while isinstance(res, (list, tuple)):    # c10d's (tensors, work)
                res = res[0]
            b = _nbytes(res)
            if kind == "reduce-scatter":
                b = _nbytes(args[0])
            st.collective_bytes[kind] = st.collective_bytes.get(kind, 0.0) + b
            st.collective_calls[kind] = st.collective_calls.get(kind, 0) + 1
        if not any(r.alias_info is not None for r in func._schema.returns):
            for t in (out if isinstance(out, (list, tuple)) else (out,)):
                if isinstance(t, torch.Tensor):
                    n = _nbytes(t)
                    self._live += n
                    weakref.finalize(t, self._free, n)
            if self._live > st.peak_temp_bytes:
                gc.collect()        # what only a cycle still holds is free
                st.peak_temp_bytes = max(st.peak_temp_bytes, self._live)
        return out
