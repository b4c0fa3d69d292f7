"""Primitives under study (paper §2.3), functional parts, from
:mod:`repro.core.primitives`: the graph inputs, the data and oracles of
the sparse skinny GEMM and of push, and the plain versions of vector-sum
and of the DGM wave step."""

from . import graphs, push, ss_gemm, vector_sum, wavesim  # noqa: F401
