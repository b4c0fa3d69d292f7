from .kernel import launch_counts, reset_launch_counts  # noqa: F401
from .ops import (paged_attn, paged_prefill_attn,  # noqa: F401
                  paged_verify_attn)
from .ref import (gather_pages, paged_attn_ref,  # noqa: F401
                  paged_prefill_attn_ref)
