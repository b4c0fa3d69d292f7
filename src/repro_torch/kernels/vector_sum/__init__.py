from .kernel import launch_counts, reset_launch_counts  # noqa: F401
from .ops import vector_sum  # noqa: F401
from .ref import vector_sum_ref  # noqa: F401
