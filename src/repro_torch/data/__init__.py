from repro_torch.data.pipeline import (  # noqa: F401
    DevicePrefetcher, ShardedLoader,
)
from repro_torch.data.streaming import (  # noqa: F401
    StreamingDataset, StreamingLoader, write_contrastive_shards,
    write_shards,
)
from repro_torch.data.synthetic import (  # noqa: F401
    ContrastiveDataset, LMDataset, PairedEmbeddingDataset,
    ZeroShotEvalDataset,
)
