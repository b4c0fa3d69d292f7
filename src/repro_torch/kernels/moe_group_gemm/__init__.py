from .kernel import launch_counts, reset_launch_counts  # noqa: F401
from .ops import group_gemm, group_gemm_backward  # noqa: F401
from .ref import (group_gemm_dw_ref, group_gemm_dxe_ref,  # noqa: F401
                  group_gemm_dy_ref, group_gemm_ref)
