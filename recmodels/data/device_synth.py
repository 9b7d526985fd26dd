"""Device-resident synthetic Criteo stream.

The host `SyntheticSource` is numpy on host cores, so on a host with few
cores `train.py` end-to-end may not reach the device rate. This module
generates the SAME planted-signal task shape
*in-graph* with `jax.random` (batches materialize in HBM inside the train
scan; zero host producer, zero host->device transfer), so
``train.py --set data=device_synth`` measures the actual product loop at
whatever the device can sustain.

Statistical (not bitwise) equivalence with `SyntheticSource._make`
(data/criteo.py:220): same dense marginals (Gamma(2, 20) -> log1p), same
uniform id marginals, same planted logit structure (dense linear +
per-(slot,bucket) weights + low-rank pairwise with identical
coefficients). Two substitutions, forced by in-graph generation:

  * Gamma(2, theta) is sampled as theta*(E1+E2) (exact for integer shape;
    cheaper than `jax.random.gamma`'s rejection loop);
  * the per-bucket weight hash is a 32-bit xorshift-multiply mix instead
    of splitmix64 (JAX without x64 mode has no u64) — a different but equally pseudo-random
    realization of the same [-1, 1) per-(slot, bucket) weight table.

Learnability is goldens-checked in tests/test_device_synth.py (same AUC
band as the host stream on the same models).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from recmodels.data.schema import Schema


def _mix32(x: jnp.ndarray) -> jnp.ndarray:
    """32-bit finalizer (xorshift-multiply, lowbias32-style constants)."""
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> jnp.uint32(15))
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> jnp.uint32(16))
    return x


def make_device_batch_fn(schema: Schema, batch_size: int, seed: int = 0,
                         task_seed: int = 0, signal_dim: int = 4):
    """Returns a pure, jittable ``batch_fn(step: i32) -> (dense [B, 13] f32,
    ids [B, S] i32, labels [B] f32)``. ``step`` is the global batch index —
    the stream is deterministic and resumable by step counter exactly like
    the host source's cursor."""
    rng = np.random.default_rng(task_seed + 1_000_003)
    dense_w = jnp.asarray(rng.normal(0, 0.6, (schema.n_dense,)), jnp.float32)
    slot_proj = jnp.asarray(
        rng.normal(0, 0.7, (schema.n_slots, signal_dim)), jnp.float32
    )
    vocab = jnp.asarray(schema.vocab_sizes, jnp.int32)[None, :]
    slot_c = (jnp.arange(schema.n_slots, dtype=jnp.uint32) * jnp.uint32(97531))[None, :]
    b = batch_size

    def bucket_weight(ids):
        h = _mix32(ids.astype(jnp.uint32) * jnp.uint32(2654435761) + slot_c)
        # take the high 24 bits -> exact f32 uniform in [0, 1)
        u = (h >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
        return (u - 0.5) * 2.0

    def batch_fn(step):
        key = jax.random.fold_in(jax.random.key(seed), step)
        kd1, kd2, ki, kl = jax.random.split(key, 4)
        # Gamma(2, 20) == 20 * (Exp + Exp); log1p transform as the host path
        e1 = -jnp.log1p(-jax.random.uniform(kd1, (b, schema.n_dense)))
        e2 = -jnp.log1p(-jax.random.uniform(kd2, (b, schema.n_dense)))
        dense = jnp.log1p(20.0 * (e1 + e2)).astype(jnp.float32)
        u = jax.random.uniform(ki, (b, schema.n_slots))
        ids = jnp.minimum((u * vocab).astype(jnp.int32), vocab - 1)
        logit = dense @ dense_w
        bw = bucket_weight(ids)
        logit = logit + bw.sum(axis=1) * 0.5
        emb = bw[:, :, None] * slot_proj[None, :, :]
        s = emb.sum(axis=1)
        logit = logit + 0.5 * ((s * s).sum(axis=1) - (emb * emb).sum(axis=(1, 2))) * 0.15
        logit = logit - logit.mean()
        p = jax.nn.sigmoid(logit)
        labels = (jax.random.uniform(kl, (b,)) < p).astype(jnp.float32)
        return dense, ids, labels

    return batch_fn


class DeviceSynthSource:
    """Cursor-only adapter (state()/set_state parity with host sources);
    batches come from ``batch_fn`` inside the jitted program, never here."""

    def __init__(self, schema: Schema, batch_size: int, seed: int = 0,
                 task_seed: int = 0):
        self.schema = schema
        self.batch_size = batch_size
        self.seed = seed
        self.task_seed = task_seed
        self._step = 0

    def state(self) -> dict:
        return {"step": self._step}

    def set_state(self, state: dict) -> None:
        self._step = int(state["step"])
