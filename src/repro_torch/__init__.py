"""PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``configs``, ``models``, ``kernels``,
``serve``, ``launch``) so each module's counterpart is found by path.  The
package imports ``torch`` and numpy only; the JAX package stays the
reference it is tested against.  Importing it builds nothing: the CUDA
kernels are compiled at their first launch (see
:mod:`repro_torch.kernels.paged_attn.kernel`).
"""
