from repro_torch.resilience.chaos import (  # noqa: F401
    ChaosInjector, flip_byte, parse_chaos, truncate_file,
)
from repro_torch.resilience.guard import (  # noqa: F401
    SpikeDetector, all_finite, grad_nonfinite_rate, select_state, step_ok,
)
from repro_torch.resilience.watchdog import (  # noqa: F401
    Heartbeat, StepWatchdog,
)
