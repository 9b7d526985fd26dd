#!/usr/bin/env python
"""On-card smoke test: the train -> export -> serve path on one NVIDIA GPU.

    python chip_smoke.py                # one card, every phase below
    python chip_smoke.py --four-cards   # row-sharded tables on 4 cards only

Phases, each reported on lines that start with its name:

  device   JAX must see a GPU (never falls back to the CPU); prints the
           card's name and power limit as nvidia-smi reports them.
  zoo      every ``bench.MODEL_KW`` model at bench widths: compile the
           train step and the forward step, print memory and compile
           seconds, run 3 steps with a finite loss.
  train    xDeepFM at full width through ``Trainer``: the loss stays
           finite and falls.
  parity   one train step and the logits on the card against the same
           program on the CPU backend of this process.
  serve    export -> load_predictor -> ragged batches, bit-exact against
           the jitted ``Engine.logits``.
  timing   plain-XLA times of the CIN stack, the row gather, the sparse
           Adagrad update and the whole train step (printed only).

``--four-cards`` runs only the row-sharded ``Trainer(n_devices=4)`` path
and its one-card ``LocalTables`` oracle.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Any failed phase raises, so the process exits non-zero and prints no
such line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# Full widths of the flagship configuration (BASELINE.json configs; bench.py).
VOCAB = 100_000
DIM = 16
CIN = (128, 128)
HIDDEN = (400, 400)
TRAIN_STEPS = 50
PARITY_BATCH = 1024
SERVE_SIZES = (1, 100, 1000, 5000)

# GPU vs CPU at matmul precision "highest", both f32. The two backends sum
# in different orders; these bounds sit a few ulps-of-accumulation above
# that noise and far below any semantic error.
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-4
TABLE_RTOL, TABLE_ATOL = 1e-4, 1e-6
# bf16-compute logits against the f32 reference: bf16 keeps ~3 significant
# digits in every matmul input, accumulated over CIN(128,128) and the MLP.
BF16_LOGIT_ATOL = 5e-2
# four cards vs one: the same f32 math under different fusion groupings
# (tests/test_sharded.py compares the same way)
SHARD_LOSS_RTOL = 1e-5
SHARD_TABLE_RTOL, SHARD_TABLE_ATOL = 1e-4, 1e-5

# Published dense peaks (NVIDIA data sheets, SXM parts, full power limit).
PEAKS = {
    "NVIDIA H200": {"bf16_flops": 989e12, "hbm_bytes": 4.8e12},
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def say(phase: str, msg: str) -> None:
    print(f"{phase:<7} {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


# ----------------------------------------------------------------- helpers
def _engine(name, vocab, dim, bf16, **over):
    """An ``Engine`` for ``name`` at bench widths (bench.MODEL_KW)."""
    import jax.numpy as jnp

    from bench import MODEL_KW
    from recmodels.data import criteo_schema
    from recmodels.models import build_model
    from recmodels.train.engine import Engine

    schema = criteo_schema(vocab_size=vocab, embed_dim=dim)
    kw = dict(MODEL_KW[name], **over)
    if bf16 and name not in ("lr", "fm"):
        kw["compute_dtype"] = jnp.bfloat16
    return Engine(build_model(name, schema, **kw), dense_lr=1e-3, emb_lr=1e-2), schema


def _batch(schema, batch, seed):
    from recmodels.data import SyntheticSource

    b = next(iter(SyntheticSource(schema, batch_size=batch, seed=seed)))
    return b.dense, b.ids, b.labels


def _mib(n) -> str:
    return f"{n / 2**20:.1f} MiB"


def _max_dev(a, b) -> float:
    import numpy as np

    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# ------------------------------------------------------------------ phases
def require_gpu():
    """The devices, if the first is a GPU; otherwise exit non-zero."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (JAX's first device is "
            f"{devices[0].platform!r}); this check never runs on the CPU"
        )
    return devices


def phase_device(devices, cache) -> str:
    """Print what JAX and nvidia-smi report; return the power limit."""
    import jax

    d = devices[0]
    say("device", f"kind={d.device_kind!r} count={len(devices)} jax={jax.__version__} "
                  f"compile_cache={cache}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"not available ({e})"
    for line in smi.splitlines() or [smi]:
        say("device", f"nvidia-smi: {line}")
    return smi.splitlines()[0].split(",")[-1].strip() if smi else smi


def phase_zoo(models, vocab, dim, batch_of, steps=3):
    """Compile train + forward for each model, run ``steps`` steps."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    rows = {}
    for name in models:
        eng, schema = _engine(name, vocab, dim, bf16=True)
        b = batch_of(name)
        dense, ids, labels = map(jnp.asarray, _batch(schema, b, seed=1))
        state = eng.init(jax.random.key(0))
        t0 = time.perf_counter()
        train = eng.jit_train_step().lower(state, dense, ids, labels).compile()
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        fwd = jax.jit(eng.logits).lower(state, dense, ids).compile()
        t_fwd = time.perf_counter() - t0
        losses = []
        for _ in range(steps):
            state, m = train(state, dense, ids, labels)
            losses.append(float(m["loss"]))
        logits = np.asarray(fwd(state, dense, ids))
        check(np.all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
        check(logits.shape == (b,) and np.all(np.isfinite(logits)),
              f"{name}: bad logits {logits.shape}")
        mt, mf = train.memory_analysis(), fwd.memory_analysis()
        say("zoo", f"{name:<9} batch={b} compile train={t_train:.1f}s fwd={t_fwd:.1f}s "
                   f"train mem args={_mib(mt.argument_size_in_bytes)} "
                   f"temp={_mib(mt.temp_size_in_bytes)} out={_mib(mt.output_size_in_bytes)} "
                   f"alias={_mib(mt.alias_size_in_bytes)} | fwd temp={_mib(mf.temp_size_in_bytes)} "
                   f"| losses={[round(x, 5) for x in losses]}")
        rows[name] = losses
        del state, train, fwd
    return rows


def _recorder():
    """A MetricsLogger that also keeps the train losses it logs."""
    from recmodels.utils.logging import MetricsLogger

    class Recorder(MetricsLogger):
        def __init__(self):
            super().__init__()
            self.losses = []

        def log_scalars(self, step, scalars, prefix="train"):
            super().log_scalars(step, scalars, prefix=prefix)
            if prefix == "train":
                self.losses.append(float(scalars["loss"]))

    return Recorder()


def flagship_config(**over):
    from recmodels.utils.config import TrainConfig

    kw = dict(model="xdeepfm", bf16=True, vocab_size=VOCAB, embed_dim=DIM,
              cin_sizes=CIN, hidden=HIDDEN, batch_size=16_384, steps=TRAIN_STEPS,
              log_every=5, eval_every=TRAIN_STEPS, eval_batches=4, n_devices=1)
    kw.update(over)
    return TrainConfig(**kw)


def phase_train(cfg):
    """Train through ``Trainer``; returns it (its ``state`` is the result)."""
    import numpy as np

    from recmodels.train.loop import Trainer

    rec = _recorder()
    trainer = Trainer(cfg, logger=rec)
    t0 = time.perf_counter()
    final = trainer.run()
    wall = time.perf_counter() - t0
    losses = rec.losses
    check(len(losses) >= 4 and np.all(np.isfinite(losses)), f"bad losses {losses}")
    k = len(losses) // 3
    first, last = np.mean(losses[:k]), np.mean(losses[-k:])
    check(last < first, f"loss did not fall: first {first:.5f} last {last:.5f}")
    say("train", f"xdeepfm steps={cfg.steps} batch={cfg.batch_size} wall={wall:.1f}s "
                 f"(compile included) loss {first:.5f} -> {last:.5f} val={final}")
    return trainer


def phase_parity(vocab, dim, batch, cin, hidden, gpu, cpu):
    """One f32 train step + logits on ``gpu`` vs ``cpu``."""
    import jax
    import numpy as np

    eng32, schema = _engine("xdeepfm", vocab, dim, bf16=False, cin_sizes=cin, hidden=hidden)
    eng16, _ = _engine("xdeepfm", vocab, dim, bf16=True, cin_sizes=cin, hidden=hidden)
    with jax.default_device(cpu):
        host_state = jax.device_get(eng32.init(jax.random.key(3)))
    args = _batch(schema, batch, seed=5)

    def run(engine, device):
        st = jax.device_put(host_state, device)
        d, i, l = jax.device_put(args, device)
        logits = jax.jit(engine.logits)(st, d, i)
        new, m = jax.jit(engine.train_step)(st, d, i, l)
        return jax.device_get((logits, m["loss"], new.emb_params))

    with jax.default_matmul_precision("highest"):
        lg_g, loss_g, emb_g = run(eng32, gpu)
        lg_c, loss_c, emb_c = run(eng32, cpu)
    lg_default = run(eng32, gpu)[0]
    lg_bf16 = run(eng16, gpu)[0]

    dev_logit = _max_dev(lg_g, lg_c)
    dev_table = max(_max_dev(emb_g[c][g], emb_c[c][g]) for c in emb_c for g in emb_c[c])
    say("parity", f"xdeepfm f32 batch={batch} highest: max|dlogit|={dev_logit:.3e} "
                  f"loss {float(loss_g):.7f} vs {float(loss_c):.7f} "
                  f"max|dtable|={dev_table:.3e}")
    np.testing.assert_allclose(lg_g, lg_c, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(loss_g), float(loss_c), rtol=LOSS_RTOL)
    for c in emb_c:
        for g in emb_c[c]:
            np.testing.assert_allclose(emb_g[c][g], emb_c[c][g], rtol=TABLE_RTOL,
                                       atol=TABLE_ATOL)
    dev_bf16 = _max_dev(lg_bf16, lg_c)
    say("parity", f"default precision max|dlogit|={_max_dev(lg_default, lg_c):.3e} "
                  f"(printed only); bf16 compute max|dlogit|={dev_bf16:.3e} "
                  f"(limit {BF16_LOGIT_ATOL})")
    check(dev_bf16 <= BF16_LOGIT_ATOL, f"bf16 logits off by {dev_bf16}")


def phase_serve(trainer, sizes=SERVE_SIZES, min_bucket=256):
    """Export the trained state, reload it, score ragged batches."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from recmodels.serve import export_model, load_predictor

    state = trainer.state
    with tempfile.TemporaryDirectory() as out:
        export_model(out, trainer.cfg, trainer.engine, jax.device_get(state))
        pred = load_predictor(out, min_bucket=min_bucket)
    ref = jax.jit(trainer.engine.logits)
    dense, ids, _ = _batch(trainer.schema, max(sizes), seed=11)
    for n in sizes:
        got = pred.predict_logits(dense[:n], ids[:n])
        b = pred._bucket(n)
        pad = lambda x: np.concatenate([x[:n], np.zeros((b - n,) + x.shape[1:], x.dtype)])
        want = np.asarray(ref(state, jnp.asarray(pad(dense)), jnp.asarray(pad(ids))))[:n]
        check(got.shape == (n,), f"predictor returned {got.shape} for {n} rows")
        check(np.array_equal(got, want),
              f"serve != engine.logits at n={n}: max dev {_max_dev(got, want):.3e}")
        say("serve", f"rows={n} bucket={b} bit-exact")


def _time(fn, args, iters):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _roof(kind, flops, nbytes, seconds, power):
    peak = PEAKS.get(kind)
    head = f"{seconds * 1e3:.3f} ms, {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB"
    if peak is None:
        return f"{head}; roofline not measured (no published peak for {kind!r})"
    t_f, t_b = flops / peak["bf16_flops"], nbytes / peak["hbm_bytes"]
    bound = "flops" if t_f >= t_b else "bytes"
    return (f"{head}; {flops / seconds / 1e12:.1f} TFLOP/s, {nbytes / seconds / 1e12:.3f} TB/s; "
            f"roofline share {max(t_f, t_b) / seconds:.1%} ({bound}-bound; power limit {power})")


def phase_timing(vocab, dim, batch, cin, hidden, iters, power, kind,
                 ref_n=8192, ref_bytes=2**30):
    """Wall times (block_until_ready) of the plain-XLA hot ops."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from recmodels.embedding.optim import (
        apply_updates, choose_dense_update, dedup_segment_sum, get_sparse_optimizer,
    )
    from recmodels.ops.interactions import cin_stack_flat

    eng, schema = _engine("xdeepfm", vocab, dim, bf16=True, cin_sizes=cin, hidden=hidden)
    state = eng.init(jax.random.key(0))
    dense, ids, labels = map(jnp.asarray, _batch(schema, batch, seed=2))
    m, bf16 = schema.n_slots, jnp.bfloat16

    # CIN stack forward + backward (bf16 in, f32 accumulation)
    x0 = jax.random.normal(jax.random.key(1), (batch, m, dim), bf16)
    ws = [w.astype(bf16) for w in state.dense_params["cin_w"]]
    cin_grad = jax.jit(jax.grad(
        lambda x, w: jnp.sum(cin_stack_flat(x, w).astype(jnp.float32)), argnums=(0, 1)))
    t = _time(cin_grad, (x0, ws), iters)
    sizes = (m,) + tuple(cin)
    fwd = sum(2 * batch * dim * sizes[k + 1] * sizes[k] * m for k in range(len(cin)))
    cin_flops = 4 * fwd  # forward + 3 backward contractions of the same size
    say("timing", f"cin fwd+bwd {cin}: " + _roof(kind, cin_flops, 2 * x0.nbytes, t, power))

    # row gather of the fused [rows, D+1] table, rows emitted in bf16
    gids = eng._group_ids(ids)["emb"]["d%d" % (dim + 1)]
    table = state.emb_params["emb"]["d%d" % (dim + 1)]
    gather = jax.jit(lambda t_, i_: t_[i_].astype(bf16))
    n, d1 = gids.size, table.shape[1]
    t = _time(gather, (table, gids), iters)
    say("timing", f"gather {n} rows x {d1}: "
                  + _roof(kind, 0, n * d1 * 4 + n * d1 * 2 + n * 4, t, power))

    # sparse Adagrad update as the engine routes it, and the dedup route
    opt = get_sparse_optimizer("adagrad")
    acc = state.emb_opt["emb"]["d%d" % (dim + 1)]
    flat_ids = gids.reshape(-1)
    grads = jax.random.normal(jax.random.key(4), (n, d1), bf16) * 1e-3
    routed = jax.jit(lambda tb, st, i_, g_: apply_updates(opt, tb, st, i_, g_, 0, 1e-2))
    dense_route = choose_dense_update(table.shape[0], d1, n, True)
    rows_b = table.shape[0] * d1 * 4
    u = int(np.unique(np.asarray(flat_ids)).size)
    sparse_bytes = n * (d1 * 2 + 4) + 4 * u * d1 * 4  # grads+ids in, rows+acc r/w
    t = _time(routed, (table, acc, flat_ids, grads), iters)
    say("timing", f"adagrad update (engine route: {'dense' if dense_route else 'dedup'}) "
                  f"{n} ids, {u} unique, table {table.shape}: "
                  + _roof(kind, 0, 7 * rows_b + n * (d1 * 2 + 4) if dense_route
                          else sparse_bytes, t, power))
    dedup = jax.jit(lambda tb, st, i_, g_: opt.apply(
        tb, st, *dedup_segment_sum(i_, g_.astype(jnp.float32), tb.shape[0])[:2], 0, 1e-2))
    t = _time(dedup, (table, acc, flat_ids, grads), iters)
    say("timing", "adagrad update (dedup route): " + _roof(kind, 0, sparse_bytes, t, power))

    # whole train step (donated state, chained)
    step = eng.jit_train_step()
    state, mt = step(state, dense, ids, labels)
    jax.block_until_ready(mt)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, mt = step(state, dense, ids, labels)
    jax.block_until_ready((state, mt))
    t = (time.perf_counter() - t0) / iters
    dims = [m * dim + schema.n_dense] + list(hidden) + [1]
    mlp = 3 * sum(2 * batch * a * b for a, b in zip(dims[:-1], dims[1:]))
    say("timing", f"train step xdeepfm batch={batch}: "
                  + _roof(kind, cin_flops + mlp, 7 * rows_b + n * d1 * 6, t, power)
                  + f"; {batch / t:,.0f} examples/s")

    # what the card reaches on a large bf16 matmul and a large copy
    a = jax.random.normal(jax.random.key(5), (ref_n, ref_n), bf16)
    t = _time(jax.jit(lambda x: x @ x), (a,), iters)
    say("timing", f"reference bf16 matmul {ref_n}^3: {2 * ref_n**3 / t / 1e12:.1f} TFLOP/s")
    big = jnp.ones((ref_bytes // 4,), jnp.float32)
    t = _time(jax.jit(lambda x: x * 1.5), (big,), iters)
    say("timing", f"reference read+write of {_mib(big.nbytes)}: "
                  f"{2 * big.nbytes / t / 1e12:.3f} TB/s")


def phase_four_cards(cfg, steps=3):
    """``Trainer(n_devices=4)`` vs the one-card ``LocalTables`` oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from recmodels.models import build_model
    from recmodels.train.engine import Engine
    from recmodels.train.loop import Trainer, build_schema

    devices = jax.devices()
    check(len(devices) >= cfg.n_devices, f"need {cfg.n_devices} devices, have {len(devices)}")
    schema = build_schema(cfg)
    batches = [_batch(schema, cfg.batch_size, 20 + k) for k in range(steps)]
    with jax.default_matmul_precision("highest"):
        trainer = Trainer(cfg, logger=_recorder())
        state_s = trainer._shard(trainer.engine.init(jax.random.key(cfg.seed)))
        loss_s, overflow = [], 0
        for d, i, l in batches:
            state_s, ms = trainer.train_step(state_s, trainer._put(d), trainer._put(i),
                                             trainer._put(l))
            loss_s.append(float(ms["loss"]))
            overflow += int(ms["overflow"])
        jax.block_until_ready(state_s)
        in_use = [(dev.memory_stats() or {}).get("bytes_in_use") for dev in devices[:cfg.n_devices]]
        table = state_s.emb_params["emb"]["d%d" % (cfg.embed_dim + 1)]
        shard_shapes = sorted({tuple(s.data.shape) for s in table.addressable_shards})

        eng_l = Engine(build_model(cfg.model, trainer.schema, **cfg.model_kwargs()),
                       dense_optimizer=cfg.dense_optimizer, sparse_optimizer=cfg.sparse_optimizer,
                       dense_lr=cfg.dense_lr, emb_lr=cfg.emb_lr)
        state_l = eng_l.init(jax.random.key(cfg.seed))
        step_l = eng_l.jit_train_step()
        loss_l = []
        for d, i, l in batches:
            state_l, ml = step_l(state_l, jnp.asarray(d), jnp.asarray(i), jnp.asarray(l))
            loss_l.append(float(ml["loss"]))
    say("4cards", f"{cfg.model} f32 global batch={cfg.batch_size} on {cfg.n_devices} devices, "
                  f"{steps} steps: loss sharded={loss_s} local={loss_l} overflow={overflow}")
    say("4cards", f"bytes_in_use per device={in_use}; table {tuple(table.shape)} "
                  f"shards={shard_shapes}")
    check(overflow == 0, f"{overflow} lookups overflowed their buckets")
    np.testing.assert_allclose(loss_s, loss_l, rtol=SHARD_LOSS_RTOL)
    worst = 0.0
    for c, coll in eng_l.collections.items():
        for g in coll.groups:
            got = np.asarray(state_s.emb_params[c][g.name])[: g.total_rows]
            want = np.asarray(state_l.emb_params[c][g.name])[: g.total_rows]
            worst = max(worst, _max_dev(got, want))
            np.testing.assert_allclose(got, want, rtol=SHARD_TABLE_RTOL, atol=SHARD_TABLE_ATOL)
    say("4cards", f"tables match the oracle: max|dtable|={worst:.3e}")
    check(len(shard_shapes) == 1 and shard_shapes[0][0] * cfg.n_devices == table.shape[0],
          f"table not split over {cfg.n_devices} devices: {shard_shapes}")


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the row-sharded 4-card path and its oracle")
    args = ap.parse_args(argv)

    # the parity phase needs the CPU backend beside the GPU
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    devices = require_gpu()

    import jax

    from bench import DEFAULT_BATCH, DEFAULT_BATCH_OTHER, MODEL_KW
    from recmodels.utils.compile_cache import enable_compile_cache

    t_start = time.perf_counter()
    power = phase_device(devices, enable_compile_cache())
    kind = devices[0].device_kind

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        say(name, f"phase ok in {time.perf_counter() - t0:.1f}s")
        return out

    if args.four_cards:
        timed("4cards", phase_four_cards,
              flagship_config(bf16=False, n_devices=4, steps=3))
    else:
        timed("zoo", phase_zoo, sorted(MODEL_KW), VOCAB, DIM,
              lambda n: DEFAULT_BATCH.get(n, DEFAULT_BATCH_OTHER))
        trainer = timed("train", phase_train, flagship_config())
        timed("parity", phase_parity, VOCAB, DIM, PARITY_BATCH, CIN, HIDDEN,
              devices[0], jax.devices("cpu")[0])
        timed("serve", phase_serve, trainer)
        timed("timing", phase_timing, VOCAB, DIM, 16_384, CIN, HIDDEN, 20, power, kind)
    say("total", f"{time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind, "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
