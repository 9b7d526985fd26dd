"""The outer training loop: data feed, logging, eval, checkpoint, resume.

Parity with the reference's ``Optimizer.optimize()`` driver loop + Trigger
system (SURVEY.md §2a #11, #14, #15): periodic validation (streaming AUC /
logloss), periodic checkpoints (model + BOTH optimizer states + data
cursor), TensorBoard scalars, throughput accounting. Host-side Python does
no math — every step is the jit'd engine step.
"""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp

from recmodels.data import CriteoTSVSource, SyntheticSource, criteo_schema
from recmodels.data.schema import Schema
from recmodels.models import build_model
from recmodels.train import metrics as metrics_lib
from recmodels.train.checkpoint import CheckpointManager
from recmodels.train.engine import Engine
from recmodels.utils.config import TrainConfig
from recmodels.utils.logging import MetricsLogger


def build_schema(cfg: TrainConfig) -> Schema:
    dims = list(cfg.per_slot_dims) if cfg.per_slot_dims else cfg.embed_dim
    return criteo_schema(vocab_size=cfg.vocab_size, embed_dim=dims)


def build_source(cfg: TrainConfig, schema: Schema, spec: str, seed: int,
                 shard_index: int = 0, shard_count: int = 1, loop: bool = True):
    if spec == "synthetic":
        return SyntheticSource(
            schema, cfg.batch_size, seed=seed, shard_index=shard_index, shard_count=shard_count
        )
    return CriteoTSVSource(
        spec,
        schema,
        cfg.batch_size,
        shard_index=shard_index,
        shard_count=shard_count,
        loop=loop,
        shuffle_buffer=cfg.shuffle_buffer,
        seed=seed,
    )


def make_producer_pool(source, workers: int):
    """Parallel batch-generation pool for RANDOM-ACCESS sources (pure
    ``_make(step)`` — SyntheticSource). Numpy generation holds the GIL, so
    threads don't scale — this uses SPAWNED processes that stay off the
    accelerator (data/genpool.py). Returns the pool, or None when the
    source does not support random access."""
    from recmodels.data import genpool

    return genpool.make_pool(source, workers)


class Trainer:
    """Trainer; picks local vs sharded tables by device count.

    Multi-HOST (``jax.process_count() > 1``, after ``multihost.initialize``):
    every process runs this same loop; each feeds its per-host data shard and
    batches are assembled into global arrays with
    ``jax.make_array_from_process_local_data`` (the JAX-native replacement for
    the reference's driver-side RDD dispatch, SURVEY.md §3.1). TB logs and
    checkpoint metadata are written by the primary host only.
    """

    def __init__(self, cfg: TrainConfig, logger: MetricsLogger | None = None):
        from recmodels.parallel import multihost

        self.cfg = cfg
        self.schema = build_schema(cfg)
        self.logger = logger or MetricsLogger(
            cfg.tb_dir if multihost.is_primary() else None
        )
        model = build_model(cfg.model, self.schema, **cfg.model_kwargs())

        from recmodels.train.schedules import build_lr_schedule

        def _sched(base):
            s = build_lr_schedule(
                base, cfg.lr_schedule, warmup_steps=cfg.warmup_steps,
                total_steps=cfg.steps, end_scale=cfg.lr_end_scale,
            )
            return None if isinstance(s, float) else s

        sched_kw = {
            "dense_lr_schedule": _sched(cfg.dense_lr),
            "emb_lr_schedule": _sched(cfg.emb_lr),
            "dense_weight_decay": cfg.dense_weight_decay,
        }

        n_dev = cfg.n_devices or len(jax.devices())
        self.n_devices = n_dev
        if n_dev > 1:
            from recmodels.parallel import (
                build_parallel_engine,
                build_parallel_scan,
                build_parallel_steps,
                make_mesh,
                shard_state,
            )

            self.mesh = make_mesh(n_dev)
            self.engine = build_parallel_engine(
                model,
                self.mesh,
                dense_optimizer=cfg.dense_optimizer,
                sparse_optimizer=cfg.sparse_optimizer,
                dense_lr=cfg.dense_lr,
                emb_lr=cfg.emb_lr,
                capacity_factor=cfg.capacity_factor,
                **sched_kw,
            )
            self._shard = lambda s: shard_state(s, self.mesh)
            if cfg.accum_steps > 1:
                from recmodels.parallel import build_parallel_accum

                self.train_step = build_parallel_accum(self.engine, self.mesh)
                _, self.eval_step = build_parallel_steps(self.engine, self.mesh)
                self.train_scan = (
                    build_parallel_accum(self.engine, self.mesh, scan=True)
                    if cfg.scan_steps > 1 else None
                )
            else:
                self.train_step, self.eval_step = build_parallel_steps(self.engine, self.mesh)
                self.train_scan = (
                    build_parallel_scan(self.engine, self.mesh) if cfg.scan_steps > 1 else None
                )
        else:
            self.mesh = None
            self.engine = Engine(
                model,
                dense_optimizer=cfg.dense_optimizer,
                sparse_optimizer=cfg.sparse_optimizer,
                dense_lr=cfg.dense_lr,
                emb_lr=cfg.emb_lr,
                **sched_kw,
            )
            self._shard = lambda s: s
            self.eval_step = self.engine.jit_eval_step()
            if cfg.accum_steps > 1:
                self.train_step = self.engine.jit_train_step_accum()
                self.train_scan = (
                    self.engine.jit_train_scan_accum() if cfg.scan_steps > 1 else None
                )
            else:
                self.train_step = self.engine.jit_train_step()
                self.train_scan = self.engine.jit_train_scan() if cfg.scan_steps > 1 else None
        if cfg.accum_steps > 1 and cfg.batch_size % cfg.accum_steps:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by accum_steps"
                f" {cfg.accum_steps}"
            )

        self.ckpt = (
            CheckpointManager(cfg.ckpt_dir, save_interval_steps=cfg.ckpt_every)
            if cfg.ckpt_dir
            else None
        )
        self.profile_dir: str | None = None  # set to capture a trace of steps 10-20

    # --------------------------------------------------------- batch placement
    def _put(self, arr, leading_dims: int = 1):
        """numpy host array -> device array. On a mesh, the batch axis is
        split over 'data'; multi-process runs contribute their local shard
        via make_array_from_process_local_data (each host's arrays are its
        slice of the global batch)."""
        import numpy as np

        arr = np.asarray(arr)
        if self.mesh is None:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding, PartitionSpec as P

        from recmodels.parallel.mesh import DATA_AXIS

        axes = [None] * arr.ndim
        axes[leading_dims - 1] = DATA_AXIS  # [K, B, ...] splits B; [B, ...] splits B
        sharding = NamedSharding(self.mesh, P(*axes))
        if jax.process_count() > 1:
            return jax.make_array_from_process_local_data(sharding, arr)
        return jax.device_put(arr, sharding)

    # ------------------------------------------------------------------ run
    def run(self) -> dict:
        if self.cfg.data == "device_synth":
            return self._run_device_synth()
        cfg = self.cfg
        state = self._shard(self.engine.init(jax.random.key(cfg.seed)))
        from recmodels.parallel import multihost

        h_idx, h_cnt = multihost.host_shard()
        source = build_source(
            cfg, self.schema, cfg.data, seed=cfg.seed, shard_index=h_idx, shard_count=h_cnt
        )
        start_step = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, data_state = self.ckpt.restore(state)
            source.set_state(data_state)
            start_step = int(state.step)
            self.logger.log_text(f"resumed from checkpoint at step {start_step}")
        if cfg.ckpt_dir and multihost.is_primary():
            os.makedirs(cfg.ckpt_dir, exist_ok=True)
            with open(os.path.join(cfg.ckpt_dir, "config.json"), "w") as f:
                f.write(cfg.to_json())

        # ---- background parse/stack pipeline -------------------------------
        # The producer thread parses K batches at a time into a superbatch and
        # records the data cursor AFTER producing it; the cursor is only
        # checkpointed once the training loop has consumed that superbatch, so
        # SIGKILL-resume replays exactly the unconsumed examples
        # (tests/test_resilience.py). K>1 runs lax.scan'd multi-step programs
        # (engine.train_scan) so host dispatch amortizes — the fix for the
        # train.py-vs-bench.py throughput gap.
        import queue
        import threading

        k = max(1, cfg.scan_steps)
        total = cfg.steps - start_step
        plan = [k] * (total // k) + ([total % k] if total % k else [])
        workers = cfg.producer_workers
        if workers == 0:  # auto: parallel generation only for synthetic data
            workers = min(8, (os.cpu_count() or 4) // 2) if cfg.data == "synthetic" else 1
        pool = make_producer_pool(source, workers)
        if pool is not None:
            # pure random-access batches: generate in worker processes,
            # advance the source's cursor locally so state()/resume is
            # unchanged
            s0 = source.state()["step"]
            from recmodels.data.genpool import pool_make

            gen = pool.imap(pool_make, range(s0, s0 + total))

            def _next_batch():
                d, i, l = next(gen)
                source._step += 1
                from recmodels.data.criteo import Batch

                return Batch(dense=d, ids=i, labels=l)
        else:
            it = iter(source)

            def _next_batch():
                return next(it)
        q: queue.Queue = queue.Queue(maxsize=max(1, cfg.prefetch_batches))
        stop = threading.Event()
        err: list[BaseException] = []

        def producer():
            import numpy as np

            try:
                for kk in plan:
                    ds, iss, ls = [], [], []
                    for _ in range(kk):
                        b = _next_batch()
                        ds.append(b.dense)
                        iss.append(b.ids)
                        ls.append(b.labels)
                    if kk == 1 and k == 1:
                        arrays = (ds[0], iss[0], ls[0])
                    else:
                        arrays = (np.stack(ds), np.stack(iss), np.stack(ls))
                    item = (kk, arrays, source.state())
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 — surfaced in main thread
                err.append(e)
                q.put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()

        t_last = time.time()
        examples_since = 0
        final = {}
        step_no = start_step
        last_cursor = source.state()
        try:
            for n_sb, _ in enumerate(plan):
                item = q.get()
                if item is None:
                    raise err[0]
                kk, arrays, cursor = item
                last_cursor = cursor
                if self.profile_dir is not None and n_sb == 2:
                    jax.profiler.start_trace(self.profile_dir)
                a = self.cfg.accum_steps
                if a > 1:
                    # split each batch into A micro-batches: [.., B, ...] ->
                    # [.., A, B/A, ...] (train_step_accum consumes the
                    # concatenated stream; same optimizer math as full-batch)
                    import numpy as np

                    lead = 1 if (kk > 1 or k > 1) else 0  # scan axis present?
                    arrays = tuple(
                        np.reshape(
                            x,
                            x.shape[:lead] + (a, x.shape[lead] // a) + x.shape[lead + 1:],
                        )
                        for x in map(np.asarray, arrays)
                    )
                if kk == 1 and k == 1:
                    dense, ids, labels = (
                        self._put(x, leading_dims=1 + (a > 1)) for x in arrays
                    )
                    state, m = self.train_step(state, dense, ids, labels)
                else:
                    # jit recompiles once for a ragged tail superbatch (kk < k)
                    dense, ids, labels = (
                        self._put(x, leading_dims=2 + (a > 1)) for x in arrays
                    )
                    state, m = self.train_scan(state, dense, ids, labels)
                prev = step_no
                step_no += kk
                examples_since += kk * cfg.batch_size
                if self.profile_dir is not None and n_sb == 4:
                    jax.tree.leaves(state)[0].block_until_ready()
                    jax.profiler.stop_trace()
                    self.logger.log_text(f"profiler trace written to {self.profile_dir}")
                if prev // cfg.log_every != step_no // cfg.log_every:
                    now = time.time()
                    eps = examples_since / max(now - t_last, 1e-9)
                    scalars = {
                        "loss": float(m["loss"]),
                        "examples_per_sec": eps,
                        # dropped-lookup count: live only with SHARDED
                        # tables (capacity_factor sizing); LocalTables
                        # never drops, so single-device runs always log 0
                        # (engine.LocalTables.gather docstring)
                        "embedding_overflow": float(m.get("overflow", 0)),
                    }
                    self.logger.log_scalars(step_no, scalars)
                    t_last, examples_since = now, 0
                if cfg.eval_every and prev // cfg.eval_every != step_no // cfg.eval_every:
                    final = self.evaluate(state, step_no)
                if self.ckpt is not None:
                    self.ckpt.save(step_no, state, data_state=cursor)
        finally:
            stop.set()
            if pool is not None:
                pool.terminate()
        if cfg.eval_every and (cfg.steps % cfg.eval_every) != 0:
            final = self.evaluate(state, cfg.steps)
        if self.ckpt is not None:
            if self.ckpt.latest_step() != cfg.steps:  # loop may have saved it
                self.ckpt.save(cfg.steps, state, data_state=last_cursor, force=True)
            self.ckpt.wait()
        self.state = state
        return final

    # ------------------------------------------------- device-resident synth
    def _run_device_synth(self) -> dict:
        """Product loop with IN-GRAPH batch generation (data/device_synth.py):
        the scan generates each batch with jax.random inside the jitted
        program — zero host producer, zero host->device bytes — so train.py
        measures the loop at pure device rate. Single-device only (the host
        pipeline covers meshes)."""
        import functools

        from recmodels.data.device_synth import (
            DeviceSynthSource, make_device_batch_fn,
        )

        cfg = self.cfg
        if self.mesh is not None:
            raise NotImplementedError(
                "data=device_synth drives the single-device product loop; "
                "use the host pipeline for meshes"
            )
        if cfg.accum_steps > 1:
            raise NotImplementedError("device_synth does not compose with accum_steps")
        state = self.engine.init(jax.random.key(cfg.seed))
        source = DeviceSynthSource(self.schema, cfg.batch_size, seed=cfg.seed)
        start_step = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, data_state = self.ckpt.restore(state)
            source.set_state(data_state)
            start_step = int(state.step)
            self.logger.log_text(f"resumed from checkpoint at step {start_step}")
        if cfg.ckpt_dir:
            os.makedirs(cfg.ckpt_dir, exist_ok=True)
            with open(os.path.join(cfg.ckpt_dir, "config.json"), "w") as f:
                f.write(cfg.to_json())

        batch_fn = make_device_batch_fn(self.schema, cfg.batch_size, seed=cfg.seed)
        k = max(1, cfg.scan_steps)
        scan = jax.jit(
            functools.partial(self.engine.train_scan_gen, k=k, batch_fn=batch_fn),
            donate_argnums=(0,),
        )
        t_last = time.time()
        examples_since = 0
        final = {}
        step_no = start_step
        while step_no < cfg.steps:
            kk = min(k, cfg.steps - step_no)
            if kk != k:  # ragged tail: one recompile, same generator
                scan = jax.jit(
                    functools.partial(self.engine.train_scan_gen, k=kk, batch_fn=batch_fn),
                    donate_argnums=(0,),
                )
            state, m = scan(state, jnp.asarray(step_no, jnp.int32))
            prev = step_no
            step_no += kk
            source.set_state({"step": step_no})
            examples_since += kk * cfg.batch_size
            if prev // cfg.log_every != step_no // cfg.log_every:
                loss = float(m["loss"])  # device sync: anchors the timing
                now = time.time()
                self.logger.log_scalars(step_no, {
                    "loss": loss,
                    "examples_per_sec": examples_since / max(now - t_last, 1e-9),
                    "embedding_overflow": float(m.get("overflow", 0)),
                })
                t_last, examples_since = now, 0
            if cfg.eval_every and prev // cfg.eval_every != step_no // cfg.eval_every:
                final = self.evaluate(state, step_no)
            if self.ckpt is not None:
                self.ckpt.save(step_no, state, data_state=source.state())
        if cfg.eval_every and (cfg.steps % cfg.eval_every) != 0:
            final = self.evaluate(state, cfg.steps)
        if self.ckpt is not None:
            if self.ckpt.latest_step() != cfg.steps:
                self.ckpt.save(cfg.steps, state, data_state=source.state(), force=True)
            self.ckpt.wait()
        self.state = state
        return final

    def evaluate(self, state, step_no: int) -> dict:
        cfg = self.cfg
        val_spec = cfg.val_data or cfg.data
        if val_spec == "device_synth":
            return self._evaluate_device_synth(state, step_no)
        from recmodels.parallel import multihost

        h_idx, h_cnt = multihost.host_shard()
        # held-out stream: synthetic uses a disjoint seed, same planted task;
        # each host evaluates its own shard (histograms psum-merge on mesh)
        val_src = build_source(
            cfg, self.schema, val_spec, seed=cfg.seed + 7_777_777,
            shard_index=h_idx, shard_count=h_cnt,
        )
        auc_state = metrics_lib.auc_init()
        vit = iter(val_src)
        for _ in range(cfg.eval_batches):
            b = next(vit)
            auc_state = self.eval_step(
                state, auc_state, self._put(b.dense), self._put(b.ids), self._put(b.labels)
            )
        out = metrics_lib.auc_compute(auc_state)
        scalars = {"auc": float(out["auc"]), "logloss": float(out["logloss"])}
        self.logger.log_scalars(step_no, scalars, prefix="val")
        return scalars

    def _evaluate_device_synth(self, state, step_no: int) -> dict:
        """Held-out device-generated stream: disjoint seed, same planted
        task (task_seed), batches materialized in-graph."""
        import functools

        from recmodels.data.device_synth import make_device_batch_fn

        cfg = self.cfg
        val_fn = make_device_batch_fn(
            self.schema, cfg.batch_size, seed=cfg.seed + 7_777_777
        )

        @functools.partial(jax.jit, donate_argnums=(1,))
        def eval_gen(state, auc_state, i):
            d, ids, l = val_fn(i)
            return self.engine.eval_step(state, auc_state, d, ids, l)

        auc_state = metrics_lib.auc_init()
        for i in range(cfg.eval_batches):
            auc_state = eval_gen(state, auc_state, jnp.asarray(i, jnp.int32))
        out = metrics_lib.auc_compute(auc_state)
        scalars = {"auc": float(out["auc"]), "logloss": float(out["logloss"])}
        self.logger.log_scalars(step_no, scalars, prefix="val")
        return scalars
