"""repro_torch.eval: the zero-shot evaluation engine (port of
``repro.eval``).

Measures what the paper reports: zero-shot classification (prompt-
ensemble text classifier heads) and exact global image<->text retrieval
R@k, over embeddings extracted through the tower fast path (the
flash-attention kernel), plus the GCL eval loss through K1.  The
retrieval scan streams (rows x chunk) similarity blocks: the (N, N)
similarity matrix never materialises (``repro_torch.eval.retrieval``);
``repro_torch.eval.metrics`` holds the deterministic tie rule and
``repro_torch.eval.planted`` the known-answer oracle."""
from repro_torch.eval.classifier import (  # noqa: F401
    build_head, classify, zero_shot_metrics,
)
from repro_torch.eval.engine import (  # noqa: F401
    ClipEvaluator, evaluate_embeddings, evaluate_planted,
)
from repro_torch.eval.extraction import (  # noqa: F401
    extract_pair_embeddings, make_extract_fn,
)
from repro_torch.eval.metrics import (  # noqa: F401
    contrastive_eval_loss, lex_topk, recall_at_k, topk_accuracy,
)
from repro_torch.eval.retrieval import (  # noqa: F401
    CHUNK, make_sharded_topk, retrieval_recalls, retrieval_topk,
    sharded_retrieval_recalls, sharded_retrieval_topk, streaming_topk,
)
from repro_torch.eval.templates import (  # noqa: F401
    DEFAULT_TEMPLATES, PromptTemplate, render_prompt_bank,
)
