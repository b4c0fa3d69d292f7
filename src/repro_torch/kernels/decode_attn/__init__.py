from .kernel import launch_counts, reset_launch_counts  # noqa: F401
from .ops import decode_attn  # noqa: F401
from .ref import decode_attn_ref  # noqa: F401
