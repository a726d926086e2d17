"""Static-batch and continuous-batching serving over MX KV caches, with
SLO-class admission, preempt-and-swap, engine snapshots, seeded fault
injection and an asyncio front end with retries and a stalled-step
watchdog."""
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: F401
                                      GenerationConfig, ServeEngine)
from repro_torch.serve.faults import (Fault, FaultError,  # noqa: F401
                                      FaultPlan)
from repro_torch.serve.frontend import (AsyncServer,  # noqa: F401
                                        QuarantinedError, RejectedError,
                                        RequestStream, RetriesExhausted,
                                        latency_summary, percentile)
from repro_torch.serve.paging import (TRASH_PAGE, BlockManager,  # noqa: F401
                                      PageGrantError, pages_needed)
from repro_torch.serve.prefix import PrefixCache  # noqa: F401
from repro_torch.serve.scheduler import (Request, RequestState,  # noqa: F401
                                         Scheduler)
from repro_torch.serve.snapshot import (EngineSnapshot, capture,  # noqa: F401
                                        restore)
from repro_torch.serve.swap import HostSwapStore, SwapData  # noqa: F401
from repro_torch.serve.traffic import (Arrival, TrafficClass,  # noqa: F401
                                       load_trace, on_off_times,
                                       poisson_times, replay, save_trace,
                                       synthesize)
