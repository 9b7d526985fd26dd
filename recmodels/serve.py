"""Standalone model export + forward-only serving.

Reference parity: BigDL's ``Module.saveModule`` / ``Module.loadModule`` and
the forward-only scoring path (SURVEY.md §2a #15, §3.3) — a trained model as
a self-contained artifact, decoupled from the TRAINING checkpoint (orbax
state with optimizer moments, data cursor, step counter). The artifact is
portable across backends and table strategies: row-sharded masters are
trimmed to plain 2-D ``[rows, dim]`` (1-D for dim-1 groups) float32 on
export.

Artifact layout (a directory):
  model.json — the run's ``TrainConfig`` JSON (model + schema + hyperparams;
               the same file a training run writes to its ckpt dir)
  params.npz — ``dense/<index>`` leaves in the model's stable pytree
               flatten order plus ``emb/<collection>/<group>`` canonical
               tables; a ``treedef`` sanity string guards against loading
               into a structurally different model.

Usage:
    from recmodels.serve import export_model, load_predictor
    export_model(out_dir, cfg, engine, state)
    pred = load_predictor(out_dir)
    probs = pred.predict_proba(dense, ids)        # any batch size; ragged ok

CLI: ``python export.py --ckpt-dir runs/x --out artifacts/x`` then
``python predict.py --model-dir artifacts/x --data test.tsv``.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from recmodels.utils.config import TrainConfig


def _canonical_tables(engine, emb_params) -> Dict[str, np.ndarray]:
    """{coll/group: canonical [alloc_rows, dim] (or [alloc_rows]) f32}."""
    out = {}
    for name, coll in engine.collections.items():
        for g in coll.groups:
            t = emb_params[name][g.name][: g.alloc_rows]  # drop shard padding
            out[f"emb/{name}/{g.name}"] = np.asarray(t, np.float32)
    return out


def export_model(out_dir: str, cfg: TrainConfig, engine, state) -> None:
    """Write a self-contained serving artifact from a live engine + state.

    Works for LocalTables and (global, unsharded-view) ShardedTables states;
    fetch the state to host first if it lives on a mesh."""
    os.makedirs(out_dir, exist_ok=True)
    leaves, treedef = jax.tree_util.tree_flatten(state.dense_params)
    arrays = {f"dense/{i}": np.asarray(l) for i, l in enumerate(leaves)}
    arrays.update(_canonical_tables(engine, state.emb_params))
    np.savez(os.path.join(out_dir, "params.npz"), **arrays,
             treedef=np.array(str(treedef)))
    with open(os.path.join(out_dir, "model.json"), "w") as f:
        f.write(cfg.to_json())


def export_from_checkpoint(ckpt_dir: str, out_dir: str) -> None:
    """Restore the latest training checkpoint and export it for serving."""
    from recmodels.train.loop import Trainer

    with open(os.path.join(ckpt_dir, "config.json")) as f:
        cfg = TrainConfig.from_json(f.read())
    cfg = cfg.apply_overrides([f"ckpt_dir={ckpt_dir!r}", "tb_dir=None"])
    trainer = Trainer(cfg)
    state = trainer._shard(trainer.engine.init(jax.random.key(cfg.seed)))
    state, _ = trainer.ckpt.restore(state)
    state = jax.device_get(state)
    export_model(out_dir, cfg, trainer.engine, state)


class Predictor:
    """Forward-only scorer over an exported artifact.

    Accepts any batch size: inputs are padded to power-of-two buckets so the
    number of distinct compiled shapes stays logarithmic, and padded rows
    are sliced off the output (reference behavior: ``model.predict`` scores
    every row — SURVEY.md §3.3)."""

    def __init__(self, engine, state, min_bucket: int = 256):
        self.engine = engine
        self.state = state
        self.min_bucket = min_bucket
        self._logits = jax.jit(engine.logits)

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return b

    def predict_logits(self, dense, ids) -> np.ndarray:
        dense = np.asarray(dense, np.float32)
        ids = np.asarray(ids, np.int32)
        n = dense.shape[0]
        b = self._bucket(n)
        if b != n:
            dense = np.concatenate(
                [dense, np.zeros((b - n,) + dense.shape[1:], dense.dtype)]
            )
            ids = np.concatenate(
                [ids, np.zeros((b - n,) + ids.shape[1:], ids.dtype)]
            )
        out = self._logits(self.state, jnp.asarray(dense), jnp.asarray(ids))
        return np.asarray(out)[:n]

    def predict_proba(self, dense, ids) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.predict_logits(dense, ids)))

    __call__ = predict_proba


def load_predictor(model_dir: str, min_bucket: int = 256) -> Predictor:
    """Rebuild the model from an artifact and return a jitted scorer.

    Serving is single-device (LocalTables) regardless of how the model was
    trained."""
    from recmodels.train.engine import Engine
    from recmodels.train.loop import build_schema
    from recmodels.models import build_model

    with open(os.path.join(model_dir, "model.json")) as f:
        cfg = TrainConfig.from_json(f.read())
    data = np.load(os.path.join(model_dir, "params.npz"))
    schema = build_schema(cfg)
    model = build_model(cfg.model, schema, **cfg.model_kwargs())
    engine = Engine(
        model,
        dense_optimizer=cfg.dense_optimizer,
        sparse_optimizer=cfg.sparse_optimizer,
        dense_lr=cfg.dense_lr,
        emb_lr=cfg.emb_lr,
    )
    state = engine.init(jax.random.key(0))
    leaves, treedef = jax.tree_util.tree_flatten(state.dense_params)
    if str(treedef) != str(data["treedef"]):
        raise ValueError(
            f"artifact/model structure mismatch:\n  artifact {data['treedef']}"
            f"\n  model    {treedef}"
        )
    dense_params = jax.tree_util.tree_unflatten(
        treedef,
        [jnp.asarray(data[f"dense/{i}"], l.dtype) for i, l in enumerate(leaves)],
    )
    emb_params = {}
    for name, coll in engine.collections.items():
        emb_params[name] = {}
        for g in coll.groups:
            t = jnp.asarray(data[f"emb/{name}/{g.name}"], jnp.float32)
            assert t.shape[0] == g.alloc_rows, (t.shape, g.alloc_rows)
            emb_params[name][g.name] = t
    state = state._replace(dense_params=dense_params, emb_params=emb_params)
    return Predictor(engine, state, min_bucket=min_bucket)
