from recmodels.train.metrics import AUCState, auc_init, auc_update, auc_compute
from recmodels.train.engine import Engine, TrainState

__all__ = ["AUCState", "auc_init", "auc_update", "auc_compute", "Engine", "TrainState"]
