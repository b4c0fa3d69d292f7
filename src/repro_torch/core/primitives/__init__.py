"""Primitives under study (paper §2.3), from :mod:`repro.core.primitives`:
the graph inputs, each primitive's problem sizes, data and oracles, and
its model (amenability profile, GPU baseline, PIM command stream, PIM
time and speedups) for vector-sum, the DGM wave step's volume and flux,
the sparse skinny GEMM and push."""

from . import graphs, push, ss_gemm, vector_sum, wavesim  # noqa: F401
