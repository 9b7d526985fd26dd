#!/usr/bin/env python
"""Benchmark harness — prints one JSON line per measurement.

Metric: Criteo examples/sec/device at xDeepFM (CIN(128,128) + DNN(400,400),
26 slots, 1e5 hashed vocab, dim 16), training step (fwd+bwd+optimizers),
one device. Data is the synthetic Criteo-shaped stream (shapes, dtypes and
id distributions match the frozen spec).

``--model``/``--batch``/... override; ``--all`` prints a line per model.
``vs_baseline`` is 1.0: there are no baselines on the current card yet
(ROADMAP Speed 2).
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp

MODEL_KW = {
    "lr": {},
    "fm": {},
    "deepfm": {"hidden": (400, 400, 400)},
    "pnn": {"hidden": (400, 400), "mode": "both"},
    "dcn": {"hidden": (512, 256), "n_cross": 3},
    "xdeepfm": {"hidden": (400, 400), "cin_sizes": (128, 128)},
    "widedeep": {"hidden": (256, 128)},
    "nfm": {"hidden": (128, 128)},
    "afm": {"attention_dim": 32},
}

# Per-model default batch, inherited from an earlier sweep; ROADMAP Speed 2
# re-derives it on the current card.
DEFAULT_BATCH = {"fm": 8192}
DEFAULT_BATCH_OTHER = 16384


def bench_model(name: str, batch: int, steps: int, warmup: int, vocab: int, dim: int,
                bf16: bool, sparse_opt: str = "adagrad") -> dict:
    """Times a lax.scan of ``steps`` train steps as ONE device program
    (dispatch-free), via two anchored runs so constant dispatch+fetch
    overhead cancels. Each run ends in a value fetch of the loss, which
    waits for the whole program."""
    from recmodels.data import SyntheticSource, criteo_schema
    from recmodels.models import build_model
    from recmodels.train.engine import Engine

    schema = criteo_schema(vocab_size=vocab, embed_dim=dim)
    kw = dict(MODEL_KW[name])
    if bf16 and name not in ("lr", "fm"):
        kw["compute_dtype"] = jnp.bfloat16
    model = build_model(name, schema, **kw)
    engine = Engine(model, dense_lr=1e-3, emb_lr=1e-2, sparse_optimizer=sparse_opt)
    state = engine.init(jax.random.key(0))
    scan = engine.jit_train_scan()

    def superbatch(k, seed):
        src = SyntheticSource(schema, batch_size=batch, seed=seed)
        it = iter(src)
        ds, iss, ls = [], [], []
        for _ in range(k):
            b = next(it)
            ds.append(b.dense)
            iss.append(b.ids)
            ls.append(b.labels)
        import numpy as np

        return (
            jnp.asarray(np.stack(ds)),
            jnp.asarray(np.stack(iss)),
            jnp.asarray(np.stack(ls)),
        )

    small = superbatch(1, seed=0)
    big = superbatch(steps, seed=1)

    t_compile = time.time()
    state, m = scan(state, *small)
    float(m["loss"])
    compile_s = time.time() - t_compile
    # big superbatch triggers a second compile (different K)
    state, m = scan(state, *big)
    float(m["loss"])

    def run(sb):
        nonlocal state
        t0 = time.time()
        state, m = scan(state, *sb)
        float(m["loss"])
        return time.time() - t0

    t1 = min(run(small) for _ in range(3))
    t2 = min(run(big) for _ in range(3))
    dt = max((t2 - t1) / (steps - 1), 1e-9)
    eps = batch / dt
    return {
        "model": name,
        "examples_per_sec": eps,
        "step_ms": 1000.0 * dt,
        "batch": batch,
        "compile_plus_warmup_s": round(compile_s, 2),
        "device": str(jax.devices()[0]),
    }


def bench_sharded_tax(name: str, batch: int, steps: int, vocab: int,
                      dim: int, bf16: bool, capacity: float = 2.0) -> dict:
    """The sharded-step tax on ONE device: the full
    shard_map program (capacity-bucketed plan, all_to_all pair — degenerate
    at n=1 — row-sharded update, psum'd dense grads) on a 1-device mesh vs
    the LocalTables step at the SAME batch. The ratio bounds real
    multi-chip efficiency from above: N chips can at best deliver
    N x local x (1/tax) examples/s before any ICI time."""
    import numpy as np

    from recmodels.data import SyntheticSource, criteo_schema
    from recmodels.models import build_model
    from recmodels.parallel import (
        build_parallel_engine, build_parallel_scan, make_mesh, shard_state,
    )
    from recmodels.train.engine import Engine

    schema = criteo_schema(vocab_size=vocab, embed_dim=dim)
    kw = dict(MODEL_KW[name])
    if bf16 and name not in ("lr", "fm"):
        kw["compute_dtype"] = jnp.bfloat16

    def eps_of(scan, state):
        src = iter(SyntheticSource(schema, batch_size=batch, seed=1))
        ds, iss, ls = zip(*((b.dense, b.ids, b.labels)
                            for b, _ in zip(src, range(steps))))
        xs = (jnp.asarray(np.stack(ds)), jnp.asarray(np.stack(iss)),
              jnp.asarray(np.stack(ls)))
        small = tuple(x[:1] for x in xs)
        state, m = scan(state, *small)
        float(m["loss"])
        state, m = scan(state, *xs)
        float(m["loss"])

        def run(sb):
            nonlocal state
            t0 = time.time()
            state, m = scan(state, *sb)
            float(m["loss"])
            return time.time() - t0

        t1 = min(run(small) for _ in range(3))
        t2 = min(run(xs) for _ in range(3))
        return batch / max((t2 - t1) / (steps - 1), 1e-9)

    model = build_model(name, schema, **kw)
    eng_l = Engine(model, dense_lr=1e-3, emb_lr=1e-2)
    eps_local = eps_of(eng_l.jit_train_scan(), eng_l.init(jax.random.key(0)))

    mesh = make_mesh(1)
    model2 = build_model(name, schema, **kw)
    eng_s = build_parallel_engine(model2, mesh, dense_lr=1e-3, emb_lr=1e-2,
                                  capacity_factor=capacity)
    state_s = shard_state(eng_s.init(jax.random.key(0)), mesh)
    eps_shard = eps_of(build_parallel_scan(eng_s, mesh), state_s)
    return {
        "model": name,
        "examples_per_sec_local": round(eps_local, 1),
        "examples_per_sec_sharded_1dev": round(eps_shard, 1),
        "sharded_step_tax": round(eps_local / max(eps_shard, 1e-9), 4),
        "capacity_factor": capacity,
        "batch": batch,
        "device": str(jax.devices()[0]),
    }


def bench_infer(name: str, batch: int, steps: int, vocab: int, dim: int,
                bf16: bool) -> dict:
    """Forward-only (serving) throughput: a lax.scan of ``steps`` logits
    batches as one device program, same anchored two-run timing as
    bench_model."""
    import numpy as np

    from recmodels.data import SyntheticSource, criteo_schema
    from recmodels.models import build_model
    from recmodels.train.engine import Engine

    schema = criteo_schema(vocab_size=vocab, embed_dim=dim)
    kw = dict(MODEL_KW[name])
    if bf16 and name not in ("lr", "fm"):
        kw["compute_dtype"] = jnp.bfloat16
    model = build_model(name, schema, **kw)
    engine = Engine(model)
    state = engine.init(jax.random.key(0))

    @jax.jit
    def infer_scan(state, dense, ids):
        def body(carry, batch):
            d, i = batch
            return carry, engine.logits(state, d, i)

        _, logits = jax.lax.scan(body, 0, (dense, ids))
        # anchor on a scalar so timing fetches one value, not [K, B] logits
        return jnp.sum(logits[-1])

    def superbatch(k, seed):
        src = iter(SyntheticSource(schema, batch_size=batch, seed=seed))
        ds, iss = zip(*((b.dense, b.ids) for b, _ in zip(src, range(k))))
        return jnp.asarray(np.stack(ds)), jnp.asarray(np.stack(iss))

    small = superbatch(1, seed=0)
    big = superbatch(steps, seed=1)
    t0 = time.time()
    float(infer_scan(state, *small))
    compile_s = time.time() - t0
    float(infer_scan(state, *big))

    def run(sb):
        t0 = time.time()
        float(infer_scan(state, *sb))
        return time.time() - t0

    t1 = min(run(small) for _ in range(3))
    t2 = min(run(big) for _ in range(3))
    dt = max((t2 - t1) / (steps - 1), 1e-9)
    return {
        "model": name,
        "examples_per_sec": batch / dt,
        "step_ms": 1000.0 * dt,
        "batch": batch,
        "compile_plus_warmup_s": round(compile_s, 2),
        "device": str(jax.devices()[0]),
    }


def bench_scaling(name: str, devices: int, batch_per_device: int, steps: int,
                  vocab: int, dim: int, bf16: bool) -> dict:
    """Scaling-efficiency harness (BASELINE.json:5 '>=80% examples/s scaling
    efficiency'): times the sharded train_scan (row-sharded tables +
    all_to_all + psum under shard_map) on an n-device mesh vs the same code
    on a 1-device mesh, with CONSTANT per-device batch (weak scaling).
    On a CPU device mesh the numbers check the program, not performance."""
    import numpy as np

    from recmodels.data import SyntheticSource, criteo_schema
    from recmodels.models import build_model
    from recmodels.parallel import (
        build_parallel_engine,
        build_parallel_scan,
        make_mesh,
        shard_state,
    )

    schema = criteo_schema(vocab_size=vocab, embed_dim=dim)
    kw = dict(MODEL_KW[name])
    if bf16 and name not in ("lr", "fm"):
        kw["compute_dtype"] = jnp.bfloat16

    def run_mesh(n_dev: int) -> float:
        mesh = make_mesh(n_dev)
        model = build_model(name, schema, **kw)
        engine = build_parallel_engine(model, mesh)
        state = shard_state(engine.init(jax.random.key(0)), mesh)
        scan = build_parallel_scan(engine, mesh)
        gbatch = batch_per_device * n_dev
        src = SyntheticSource(schema, batch_size=gbatch, seed=1)
        it = iter(src)
        ds, iss, ls = zip(*((b.dense, b.ids, b.labels) for b, _ in zip(it, range(steps))))
        xs = (jnp.asarray(np.stack(ds)), jnp.asarray(np.stack(iss)), jnp.asarray(np.stack(ls)))
        small = tuple(x[:1] for x in xs)
        state, m = scan(state, *small)
        float(m["loss"])
        state, m = scan(state, *xs)
        float(m["loss"])

        def run(sb):
            nonlocal state
            t0 = time.time()
            state, m = scan(state, *sb)
            float(m["loss"])
            return time.time() - t0

        t1 = min(run(small) for _ in range(3))
        t2 = min(run(xs) for _ in range(3))
        dt = max((t2 - t1) / (steps - 1), 1e-9)
        return gbatch / dt

    eps1 = run_mesh(1)
    epsn = run_mesh(devices)
    eff = (epsn / devices) / eps1
    return {
        "model": name,
        "devices": devices,
        "examples_per_sec_1dev": round(eps1, 1),
        "examples_per_sec_ndev": round(epsn, 1),
        "scaling_efficiency": round(eff, 4),
        "batch_per_device": batch_per_device,
        "platform": jax.devices()[0].platform,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="xdeepfm", choices=sorted(MODEL_KW))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--batch", type=int, default=0,
                    help="0 = per-model throughput-optimal default "
                         "(DEFAULT_BATCH table)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--vocab", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--no-bf16", action="store_true")
    ap.add_argument("--sparse-opt", default="adagrad",
                    choices=["adagrad", "adam", "adam_dense"],
                    help="embedding-table optimizer (BASELINE.json:5 "
                         "'Adam/Adagrad'); adam is lazy (touched rows only)")
    ap.add_argument("--infer", action="store_true",
                    help="forward-only (serving) throughput instead of train")
    ap.add_argument("--devices", type=int, default=0,
                    help="scaling mode: weak-scaling efficiency on an N-device "
                         "mesh (fails if fewer devices are attached)")
    ap.add_argument("--batch-per-device", type=int, default=4096)
    ap.add_argument("--capacity", type=float, default=2.0,
                    help="sharded-tax mode: table-shard bucket capacity "
                         "factor (scales every all_to_all buffer linearly)")
    ap.add_argument("--sharded-tax", action="store_true",
                    help="measure the 1-device shard_map program vs "
                         "LocalTables at the same batch (multi-chip "
                         "efficiency upper bound)")
    args = ap.parse_args()
    from recmodels.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.sharded_tax:
        batch = args.batch or DEFAULT_BATCH.get(args.model, DEFAULT_BATCH_OTHER)
        r = bench_sharded_tax(args.model, batch, max(args.steps, 8),
                              args.vocab, args.dim, bf16=not args.no_bf16,
                              capacity=args.capacity)
        print(json.dumps({
            "metric": f"{args.model}_sharded_step_tax",
            "value": r["sharded_step_tax"],
            "unit": "x_local_step_time",
            "vs_baseline": 1.0,
            **r,
        }))
        return

    if args.devices:
        if len(jax.devices()) < args.devices:
            raise SystemExit(
                f"--devices {args.devices}: only {len(jax.devices())} "
                f"{jax.devices()[0].platform} device(s) attached"
            )
        r = bench_scaling(
            args.model, args.devices, args.batch_per_device, max(args.steps, 8),
            args.vocab, args.dim, bf16=not args.no_bf16,
        )
        print(json.dumps({
            "metric": f"{args.model}_scaling_efficiency_{args.devices}dev",
            "value": r["scaling_efficiency"],
            "unit": "fraction",
            "vs_baseline": round(r["scaling_efficiency"] / 0.8, 3),  # target >=0.8
            # CPU device meshes validate the program, not performance
            "plumbing_only": r["platform"] == "cpu",
            **r,
        }))
        return

    names = sorted(MODEL_KW) if args.all else [args.model]
    for name in names:
        batch = args.batch or DEFAULT_BATCH.get(name, DEFAULT_BATCH_OTHER)
        if args.infer:
            r = bench_infer(name, batch, args.steps, args.vocab,
                            args.dim, bf16=not args.no_bf16)
        else:
            r = bench_model(
                name, batch, args.steps, args.warmup, args.vocab, args.dim,
                bf16=not args.no_bf16, sparse_opt=args.sparse_opt,
            )
        mode = "infer" if args.infer else "train"
        opt_tag = "" if (args.infer or args.sparse_opt == "adagrad") else f"_{args.sparse_opt}"
        line = {
            "metric": f"{name}{opt_tag}_{mode}_examples_per_sec_per_chip",
            "value": round(r["examples_per_sec"], 1),
            "unit": "examples/s",
            "vs_baseline": 1.0,
            **{k: r[k] for k in ("step_ms", "batch", "compile_plus_warmup_s", "device")},
        }
        print(json.dumps(line))


if __name__ == "__main__":
    main()
