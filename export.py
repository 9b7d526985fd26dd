#!/usr/bin/env python
"""Export a trained checkpoint as a standalone serving artifact — parity
with the reference's ``Module.saveModule`` (SURVEY.md §2a #15): the model
file is decoupled from optimizer state / data cursor and loads anywhere via
``recmodels.serve.load_predictor``.

    python export.py --ckpt-dir runs/xdeepfm --out artifacts/xdeepfm
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", required=True, help="artifact output directory")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from recmodels.serve import export_from_checkpoint

    export_from_checkpoint(args.ckpt_dir, args.out)
    print(f"exported {args.ckpt_dir} -> {args.out}")
    return 0


if __name__ == "__main__":
    from recmodels.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
