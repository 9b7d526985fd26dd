"""Batch-generation pool workers (used by train.loop).

Workers run numpy only. They are spawned with ``JAX_PLATFORMS=cpu`` so
that a worker that imports jax never opens the accelerator: a JAX process
reserves most of a card's memory when it first uses it, so the training
process must stay the only one on the card.
"""

from __future__ import annotations

import contextlib
import os
import pickle

_POOL_SRC = None


def pool_init(src_bytes: bytes) -> None:
    global _POOL_SRC
    _POOL_SRC = pickle.loads(src_bytes)


def pool_make(step: int):
    b = _POOL_SRC._make(step)
    return b.dense, b.ids, b.labels


@contextlib.contextmanager
def spawn_env():
    """Set ``JAX_PLATFORMS=cpu`` while children are spawned (they inherit
    os.environ), then restore the parent's value."""
    saved = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("JAX_PLATFORMS", None)
        else:
            os.environ["JAX_PLATFORMS"] = saved


def make_pool(source, workers: int):
    """Spawn a generation pool for a random-access source (pure
    ``_make(step)``); returns None when unsupported."""
    import multiprocessing as mp

    from recmodels.data.criteo import SyntheticSource

    if not isinstance(source, SyntheticSource) or workers <= 1:
        return None
    ctx = mp.get_context("spawn")
    with spawn_env():
        return ctx.Pool(workers, initializer=pool_init,
                        initargs=(pickle.dumps(source),))
