from recmodels.embedding.collection import EmbeddingCollection
from recmodels.embedding.optim import (
    SparseOptimizer,
    sparse_adagrad,
    sparse_adam,
    dedup_segment_sum,
)

__all__ = [
    "EmbeddingCollection",
    "SparseOptimizer",
    "sparse_adagrad",
    "sparse_adam",
    "dedup_segment_sum",
]
