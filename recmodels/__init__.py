"""recmodels — a CTR ranking engine in JAX.

A from-scratch JAX/XLA framework with the capability surface of the
reference repo ``yaochitc/recommendation-models`` (BigDL/Spark CTR model zoo:
LR, FM, DeepFM, PNN, DCN, xDeepFM on Criteo-style logs — see SURVEY.md §2).

Design in one paragraph: categorical features are hashed on the host into
fixed vocab buckets (``data/``); embedding lookups go through a single
``EmbeddingCollection`` engine (``embedding/``) that runs either with local
tables (single device: one fused gather) or with row-sharded tables spread
over a ``jax.sharding.Mesh`` with all-to-all ID exchange (``parallel/``);
models (``models/``) are pure functions of (dense features, embedded slots)
so the same model code runs under any sharding; feature-interaction hot ops
(FM pairwise term, DCN cross, PNN products, xDeepFM CIN) are plain
``jax.numpy`` ops (``ops/interactions.py``); training is one
jit'd step with dense Adam/Adagrad and sparse row-wise embedding optimizers
(``train/``, ``embedding/optim.py``).
"""

__version__ = "0.1.0"

# Convenience top-level API (heavier modules import lazily underneath)
from recmodels.data import criteo_schema, CriteoTSVSource, SyntheticSource  # noqa: E402
from recmodels.models import build_model, MODEL_REGISTRY  # noqa: E402
from recmodels.train.engine import Engine, TrainState  # noqa: E402
from recmodels.utils.config import TrainConfig  # noqa: E402

__all__ = [
    "criteo_schema",
    "CriteoTSVSource",
    "SyntheticSource",
    "build_model",
    "MODEL_REGISTRY",
    "Engine",
    "TrainState",
    "TrainConfig",
]
