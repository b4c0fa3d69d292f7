from .kernel import launch_counts, reset_launch_counts  # noqa: F401
from .ops import hot_set, push_scatter  # noqa: F401
from .ref import push_scatter_kernel_ref, push_scatter_ref  # noqa: F401
