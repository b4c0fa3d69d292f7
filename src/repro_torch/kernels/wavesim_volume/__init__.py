from .kernel import (fused_operator, launch_counts,  # noqa: F401
                     reset_launch_counts, stencil_operator)
from .ops import volume  # noqa: F401
from .ref import volume_kernel_ref, volume_ref  # noqa: F401
