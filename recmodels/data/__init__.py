from recmodels.data.schema import FeatureSpec, Schema, criteo_schema
from recmodels.data.hashing import hash_tokens, splitmix64
from recmodels.data.criteo import (
    Batch,
    CriteoTSVSource,
    SyntheticSource,
    make_batch_iterator,
)

__all__ = [
    "FeatureSpec",
    "Schema",
    "criteo_schema",
    "hash_tokens",
    "splitmix64",
    "Batch",
    "CriteoTSVSource",
    "SyntheticSource",
    "make_batch_iterator",
]
