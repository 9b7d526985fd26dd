"""Device mesh construction — the replacement for the reference's entire
Spark deployment layer (SURVEY.md §3.5): no driver/executor placement code,
just a named mesh that XLA lowers collectives onto. The cards of one host
reach each other all to all (NVLink), so a flat mesh fits as it is.

One flat ``data`` axis serves both roles (SURVEY.md §7): the batch is
data-parallel over it AND embedding table rows are sharded over it (the
all_to_all in parallel/sharded_embedding.py rides the same axis). Dense
towers are tiny (≪1 GB) so tensor-parallelism would be pure overhead
(SURVEY.md §2c) — they are replicated, grads psum-reduced.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))
