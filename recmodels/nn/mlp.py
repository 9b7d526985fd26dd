"""Plain functional MLP tower (the deep part of DeepFM/PNN/DCN/xDeepFM).

The reference builds these from BigDL ``Linear``/``ReLU`` modules
(SURVEY.md §2a #9). Here: explicit param pytrees + one function, so the tower
jits/shards with zero framework overhead and XLA fuses bias+ReLU into the
matmul epilogue. He-init for ReLU layers, Glorot for the linear output.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


def mlp_init(
    rng: jax.Array, in_dim: int, hidden: Sequence[int], out_dim: int | None = None
) -> list[dict]:
    """Build [in_dim -> hidden... (-> out_dim, linear)] params."""
    sizes = [in_dim, *hidden] + ([out_dim] if out_dim is not None else [])
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        rng, sub = jax.random.split(rng)
        last = out_dim is not None and i == len(sizes) - 2
        scale = np.sqrt(2.0 / a) if not last else np.sqrt(1.0 / a)
        layers.append(
            {
                "w": jax.random.normal(sub, (a, b), jnp.float32) * scale,
                "b": jnp.zeros((b,), jnp.float32),
            }
        )
    return layers


def mlp_apply(
    layers: list[dict], x: jnp.ndarray, final_linear: bool, compute_dtype=jnp.float32
) -> jnp.ndarray:
    """Forward. If final_linear, the last layer has no ReLU.

    ``compute_dtype=bfloat16`` runs matmuls in bf16 with f32
    accumulation (``preferred_element_type``); params stay f32.
    """
    h = x.astype(compute_dtype)
    n = len(layers)
    for i, layer in enumerate(layers):
        h = (
            jax.lax.dot_general(
                h,
                layer["w"].astype(compute_dtype),
                (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            + layer["b"]
        )
        if not (final_linear and i == n - 1):
            h = jax.nn.relu(h)
        h = h.astype(compute_dtype)
    return h.astype(jnp.float32)
