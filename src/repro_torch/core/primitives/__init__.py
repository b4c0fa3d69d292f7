"""Primitives under study (paper §2.3), functional parts, from
:mod:`repro.core.primitives`: the graph inputs, and the data and oracles
of the sparse skinny GEMM and of push."""

from . import graphs, push, ss_gemm  # noqa: F401
