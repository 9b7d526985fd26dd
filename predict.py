#!/usr/bin/env python
"""Batch scoring / evaluation CLI — parity with the reference's
evaluate/predict path (SURVEY.md §3.3: Module.loadModule + model.evaluate
with AUC/Loss ValidationMethods).

    python predict.py --ckpt-dir runs/xdeepfm --data test.tsv --out preds.txt
    python predict.py --ckpt-dir runs/xdeepfm --data test.tsv   # metrics only
    python predict.py --model-dir artifacts/xdeepfm --data test.tsv  # serving artifact
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    src_arg = ap.add_mutually_exclusive_group(required=True)
    src_arg.add_argument("--ckpt-dir", help="training checkpoint dir (with config.json)")
    src_arg.add_argument("--model-dir", help="exported serving artifact (export.py / serve.py)")
    ap.add_argument("--data", required=True, help="criteo TSV path or 'synthetic'")
    ap.add_argument("--out", default=None, help="write one probability per line")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from recmodels.train.loop import Trainer, build_schema, build_source
    from recmodels.train import metrics as metrics_lib
    from recmodels.utils.config import TrainConfig

    if args.model_dir:
        from recmodels.serve import load_predictor
        from recmodels.utils.logging import MetricsLogger

        with open(f"{args.model_dir}/model.json") as f:
            cfg = TrainConfig.from_json(f.read())
        overrides = [f"data={args.data!r}", "steps=0", "eval_every=0"]
        if args.batch_size:
            overrides.append(f"batch_size={args.batch_size}")
        cfg = cfg.apply_overrides(overrides)
        pred = load_predictor(args.model_dir)
        trainer = None
        logger = MetricsLogger(None)
        logger.log_text(f"loaded serving artifact from {args.model_dir}")
        state = pred.state
        logits_fn = lambda st, d, i: jnp.asarray(pred.predict_logits(d, i))  # noqa: E731
    else:
        with open(f"{args.ckpt_dir}/config.json") as f:
            cfg = TrainConfig.from_json(f.read())
        overrides = [f"data={args.data!r}", "steps=0", "eval_every=0"]
        if args.batch_size:
            overrides.append(f"batch_size={args.batch_size}")
        cfg = cfg.apply_overrides(overrides + [f"ckpt_dir={args.ckpt_dir!r}"])

        trainer = Trainer(cfg)
        logger = trainer.logger
        state = trainer._shard(trainer.engine.init(jax.random.key(cfg.seed)))
        state, _ = trainer.ckpt.restore(state)
        logger.log_text(f"restored step {int(state.step)} from {args.ckpt_dir}")

    schema = build_schema(cfg)
    # loop=False: file sources yield each row exactly once (incl. the ragged
    # tail batch, padded + masked below so every row counts toward metrics)
    source = build_source(cfg, schema, args.data, seed=cfg.seed, loop=False)
    if trainer is not None:
        logits_fn = jax.jit(trainer.engine.logits)

    auc_state = metrics_lib.auc_init()
    out_f = open(args.out, "w") if args.out else None
    n = 0
    for i, b in enumerate(source):
        if args.max_batches is not None and i >= args.max_batches:
            break
        real = b.size
        dense, ids, labels = b.dense, b.ids, b.labels
        if real != cfg.batch_size:
            # pad to the static batch shape; padded rows get zero weight
            pad = cfg.batch_size - real
            dense = np.concatenate([dense, np.zeros((pad,) + dense.shape[1:], dense.dtype)])
            ids = np.concatenate([ids, np.zeros((pad,) + ids.shape[1:], ids.dtype)])
            labels = np.concatenate([labels, np.zeros((pad,), labels.dtype)])
        weight = None
        if real != cfg.batch_size:
            weight = jnp.asarray(
                (np.arange(cfg.batch_size) < real).astype(np.float32)
            )
        lg = logits_fn(state, jnp.asarray(dense), jnp.asarray(ids))
        auc_state = metrics_lib.auc_update(
            auc_state, lg, jnp.asarray(labels), weight=weight
        )
        n += real
        if out_f:
            for p in np.asarray(jax.nn.sigmoid(lg))[:real]:
                out_f.write(f"{p:.6f}\n")
        if args.data == "synthetic" and args.max_batches is None and i >= 19:
            break  # synthetic stream is infinite
    if out_f:
        out_f.close()
    out = metrics_lib.auc_compute(auc_state)
    logger.log_text(
        f"eval n={n} auc={float(out['auc']):.6f} logloss={float(out['logloss']):.6f}"
    )
    return 0


if __name__ == "__main__":
    from recmodels.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
