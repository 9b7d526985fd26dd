from recmodels.nn.mlp import mlp_init, mlp_apply

__all__ = ["mlp_init", "mlp_apply"]
