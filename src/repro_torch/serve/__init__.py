"""Static-batch and continuous-batching serving over MX KV caches."""
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: F401
                                      GenerationConfig, ServeEngine)
from repro_torch.serve.paging import (TRASH_PAGE, BlockManager,  # noqa: F401
                                      pages_needed)
from repro_torch.serve.scheduler import (Request, RequestState,  # noqa: F401
                                         Scheduler)
