from .kernel import launch_counts, reset_launch_counts  # noqa: F401
from .ops import (PagedAttnTelemetry, amenability_reports,  # noqa: F401
                  attn_telemetry, paged_attn, paged_attn_gather,
                  paged_prefill_attn, paged_verify_attn)
from .ref import (gather_pages, paged_attn_ref,  # noqa: F401
                  paged_prefill_attn_ref)
