#!/usr/bin/env python
"""CLI entry point — parity with the reference's per-model spark-submit mains
(SURVEY.md §2a #16, §3.1) minus the cluster ceremony:

    python train.py --model xdeepfm --steps 2000 --set batch_size=4096
    python train.py --model lr --data /path/to/criteo.tsv --devices 1
    python train.py --config runs/xdeepfm/config.json   # reproduce a run
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default=None,
                    choices=["lr", "fm", "deepfm", "pnn", "dcn", "xdeepfm", "widedeep", "nfm", "afm"])
    ap.add_argument("--data", default=None, help="'synthetic' or criteo TSV path")
    ap.add_argument("--val-data", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--devices", type=int, default=None, help="1 = local tables")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--tb-dir", default=None)
    ap.add_argument("--config", default=None, help="load a config.json")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, repeatable")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a jax.profiler trace of steps 10-20 into this dir")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from recmodels.utils.config import TrainConfig
    from recmodels.train.loop import Trainer

    if args.config:
        with open(args.config) as f:
            cfg = TrainConfig.from_json(f.read())
    else:
        cfg = TrainConfig()
    direct = {
        "model": args.model,
        "data": args.data,
        "val_data": args.val_data,
        "steps": args.steps,
        "batch_size": args.batch_size,
        "n_devices": args.devices,
        "ckpt_dir": args.ckpt_dir,
        "tb_dir": args.tb_dir,
    }
    overrides = [f"{k}={v!r}" for k, v in direct.items() if v is not None]
    cfg = cfg.apply_overrides(overrides + args.set)

    trainer = Trainer(cfg)
    trainer.logger.log_text(
        f"model={cfg.model} devices={trainer.n_devices} batch={cfg.batch_size} "
        f"steps={cfg.steps} data={cfg.data}"
    )
    if args.profile_dir:
        trainer.profile_dir = args.profile_dir
    final = trainer.run()
    trainer.logger.log_text(f"done: {final}")
    return 0


if __name__ == "__main__":
    from recmodels.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
