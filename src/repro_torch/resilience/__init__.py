from repro_torch.resilience.guard import all_finite  # noqa: F401
from repro_torch.resilience.watchdog import (  # noqa: F401
    Heartbeat, StepWatchdog,
)
