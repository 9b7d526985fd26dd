"""Model zoo registry — parity with the reference's six CTR models
(SURVEY.md §2a #1-6)."""

from recmodels.models.base import CTRModel, wide_schema
from recmodels.models.lr import LRModel
from recmodels.models.fm import FMModel
from recmodels.models.deepfm import DeepFMModel
from recmodels.models.pnn import PNNModel
from recmodels.models.dcn import DCNModel
from recmodels.models.xdeepfm import XDeepFMModel
from recmodels.models.widedeep import WideDeepModel
from recmodels.models.nfm import NFMModel
from recmodels.models.afm import AFMModel

MODEL_REGISTRY = {
    "lr": LRModel,
    "fm": FMModel,
    "deepfm": DeepFMModel,
    "pnn": PNNModel,
    "dcn": DCNModel,
    "xdeepfm": XDeepFMModel,
    # adjacent classic CTR models (same engine, zero extra infrastructure)
    "widedeep": WideDeepModel,
    "nfm": NFMModel,
    "afm": AFMModel,
}


def build_model(name: str, schema, **kwargs) -> CTRModel:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](schema, **kwargs)


__all__ = [
    "CTRModel",
    "wide_schema",
    "LRModel",
    "FMModel",
    "DeepFMModel",
    "PNNModel",
    "DCNModel",
    "XDeepFMModel",
    "MODEL_REGISTRY",
    "build_model",
]
