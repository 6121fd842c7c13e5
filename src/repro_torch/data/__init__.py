from repro_torch.data.pipeline import (  # noqa: F401
    DevicePrefetcher, ShardedLoader,
)
from repro_torch.data.synthetic import (  # noqa: F401
    ContrastiveDataset, ZeroShotEvalDataset,
)
