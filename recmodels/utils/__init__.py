from recmodels.utils.config import TrainConfig
from recmodels.utils.logging import MetricsLogger

__all__ = ["TrainConfig", "MetricsLogger"]
