"""Continuous-batching serving over the paged MX KV cache."""
from repro_torch.serve.engine import ContinuousBatchingEngine  # noqa: F401
from repro_torch.serve.paging import (TRASH_PAGE, BlockManager,  # noqa: F401
                                      pages_needed)
from repro_torch.serve.scheduler import (Request, RequestState,  # noqa: F401
                                         Scheduler)
