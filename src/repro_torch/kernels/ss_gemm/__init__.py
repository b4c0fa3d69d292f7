from .kernel import (launch_counts, reset_launch_counts,  # noqa: F401
                     route, route_counts)
from .ops import (block_occupancy, ssgemm, ssgemm_compact,  # noqa: F401
                  ssgemm_masked)
from .ref import (ssgemm_compact_ref, ssgemm_masked_ref,  # noqa: F401
                  ssgemm_ref)
