from .kernel import launch_counts, reset_launch_counts  # noqa: F401
from .ops import (DecodeAttnPolicy, active_policy,  # noqa: F401
                  decode_attn, decode_attn_policy)
from .ref import decode_attn_ref  # noqa: F401
