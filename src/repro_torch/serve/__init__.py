"""Online embedding serving (port of ``repro.serve``).

Admission control, continuous micro-batching with bounded bucket shapes,
retry/backoff over an on-device finiteness guard, a circuit breaker, a
digest-verified embedding cache as the degraded path, and hot checkpoint
reload.  Contract: every response is the bucket's computed embedding (or
a cache hit bitwise equal to it) or a typed rejection, never a silent
drop.
"""
from repro_torch.serve.admission import (  # noqa: F401
    AdmissionQueue, Future, Request, ServiceTimeEstimator,
)
from repro_torch.serve.backoff import RetryPolicy, retry_call  # noqa: F401
from repro_torch.serve.batcher import (  # noqa: F401
    BucketCompute, bucket_sizes, pick_bucket, stack_pad,
)
from repro_torch.serve.breaker import CircuitBreaker  # noqa: F401
from repro_torch.serve.cache import EmbeddingCache  # noqa: F401
from repro_torch.serve.engine import EmbedServer, ServeConfig  # noqa: F401
from repro_torch.serve.errors import (  # noqa: F401
    DeadlineExceeded, NonFiniteEmbedding, Overloaded, ServeRejection,
    ServeResult, Unavailable, content_hash,
)
from repro_torch.serve.reload import (  # noqa: F401
    CheckpointWatcher, ParamsStore,
)
