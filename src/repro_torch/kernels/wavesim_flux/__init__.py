from .kernel import launch_counts, reset_launch_counts  # noqa: F401
from .ops import flux1d  # noqa: F401
from .ref import flux1d_ref  # noqa: F401
