"""The training engine: one jit'd step (forward + backward + both optimizers).

Replaces the reference's DistriOptimizer loop (SURVEY.md §2a #11, §3.1): where
BigDL dispatches Spark tasks, fetches weight partitions, runs per-core
replicas and exchanges gradients over BlockManager, here the ENTIRE step —
embedding gather, model forward, backward, dense Adam/Adagrad, sparse
row-wise embedding update — is a single XLA program. Data parallelism is the
same step run under ``shard_map`` with an ``axis_name`` (gradient ``psum``
replaces the reference's reduce-scatter/all-gather, SURVEY.md §3.4); sharded
embedding tables swap the ``LocalTables`` strategy for the all-to-all one in
``parallel/sharded_embedding.py``.

Gradient path for embeddings: the loss is differentiated wrt the *gathered
rows* (O(batch) memory), then ``dedup_segment_sum`` + sparse optimizer apply
the update — never a dense [vocab, dim] gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple

import jax
import jax.numpy as jnp
import optax

from recmodels.embedding.collection import EmbeddingCollection
from recmodels.embedding.optim import SparseOptimizer, dedup_segment_sum, get_sparse_optimizer
from recmodels.models.base import CTRModel
from recmodels.train import metrics as metrics_lib


class TrainState(NamedTuple):
    step: jnp.ndarray
    dense_params: Any
    dense_opt: Any
    emb_params: Dict[str, Dict[str, jnp.ndarray]]  # {collection: {group: table}}
    emb_opt: Dict[str, Dict[str, Any]]  # {collection: {group: state}}


class LocalTables:
    """Single-device / replicated table strategy: plain ``[rows, dim]``
    tables (1-D ``[rows]`` for dim-1 groups), XLA row gathers, and the
    sparse optimizer's XLA update routes (``optim.apply_updates``)."""

    def __init__(self, collections: Dict[str, EmbeddingCollection], sparse_opt: SparseOptimizer):
        self.collections = collections
        self.sparse_opt = sparse_opt

    def init_params(self, rng: jax.Array) -> Dict[str, Dict[str, jnp.ndarray]]:
        out = {}
        for name, coll in self.collections.items():
            rng, sub = jax.random.split(rng)
            out[name] = coll.init(sub)
        return out

    def init_opt(self) -> Dict[str, Dict[str, Any]]:
        return {
            name: {g.name: self.sparse_opt.init(g.alloc_rows, g.dim) for g in coll.groups}
            for name, coll in self.collections.items()
        }

    def gather(self, emb_params, gids, dtype=None, emb_opt=None, with_stats=False):
        """{coll: {group: [B, n_g]}} -> {coll: {group: [B, n_g, dim]}}.
        ``with_stats``: also return an overflow counter (always 0 locally —
        replicated tables never drop lookups; parity with ShardedTables)."""
        del emb_opt
        out = {}
        for name, coll in self.collections.items():
            res = {}
            for g in coll.groups:
                r = emb_params[name][g.name][gids[name][g.name]]
                if dtype is not None and r.dtype != dtype:
                    r = r.astype(dtype)  # cast fuses into the gather
                res[g.name] = r[..., None] if g.dim == 1 else r
            out[name] = res
        if with_stats:
            return out, jnp.zeros((), jnp.int32)
        return out

    def apply_grads(self, emb_params, emb_opt, gids, grad_rows, step, lr):
        from recmodels.embedding.optim import apply_updates

        new_params, new_opt = {}, {}
        for name, coll in self.collections.items():
            new_params[name], new_opt[name] = {}, {}
            for g in coll.groups:
                ids_flat = gids[name][g.name].reshape(-1)
                gr = grad_rows[name][g.name]
                # dim-1 tables are 1-D [rows]; their grads flatten to [N]
                gr_flat = gr.reshape(-1) if g.dim == 1 else gr.reshape(-1, g.dim)
                table, opt = apply_updates(
                    self.sparse_opt,
                    emb_params[name][g.name],
                    emb_opt[name][g.name],
                    ids_flat,
                    gr_flat,
                    step,
                    lr,
                )
                new_params[name][g.name] = table
                new_opt[name][g.name] = opt
        return new_params, new_opt


@dataclasses.dataclass
class Engine:
    """Wires a model + embedding collections + optimizers into jit-able steps.

    ``axis_name``: set when the step runs under shard_map data parallelism —
    loss and dense grads are ``psum``-averaged over it.
    """

    model: CTRModel
    dense_optimizer: str = "adam"
    sparse_optimizer: str = "adagrad"
    dense_lr: float = 1e-3
    emb_lr: float = 1e-2
    axis_name: str | None = None
    table_strategy: Any = None  # defaults to LocalTables
    # LR schedules (reference parity: OptimMethod LearningRateSchedule —
    # train/schedules.py): the dense one is an optax schedule passed to the
    # optimizer; the embedding one is evaluated in-graph per step.
    dense_lr_schedule: Callable[[jnp.ndarray], jnp.ndarray] | None = None
    emb_lr_schedule: Callable[[jnp.ndarray], jnp.ndarray] | None = None
    # decoupled L2 on dense params (reference parity: BigDL's per-layer
    # wRegularizer=L2Regularizer; embeddings stay decay-free — decaying
    # only touched rows would make decay depend on batch composition)
    dense_weight_decay: float = 0.0
    fuse_wide: bool = True

    def __post_init__(self):
        schemas = self.model.embedding_schemas()
        # Wide-column fusion: models that want both a dim-1 'wide' collection
        # and a vector 'emb' collection over the SAME vocab layout get ONE
        # physical table of dim D+1 whose last column is the first-order
        # weight. Saves a separate gather + dedup + update per step (and a
        # whole all_to_all round-trip in sharded mode). Mathematically
        # identical: per-element Adagrad treats columns independently.
        self._fused_wide = (
            self.fuse_wide
            and set(schemas) >= {"wide", "emb"}
            and schemas["emb"].uniform_dim
            and schemas["wide"].vocab_sizes == schemas["emb"].vocab_sizes
            and all(s.embed_dim == 1 for s in schemas["wide"].slots)
        )
        if self._fused_wide:
            import dataclasses as _dc

            from recmodels.data.schema import Schema

            emb_sch = schemas["emb"]
            self._emb_dim = emb_sch.max_dim
            fused = Schema(
                n_dense=emb_sch.n_dense,
                slots=tuple(
                    _dc.replace(s, embed_dim=s.embed_dim + 1) for s in emb_sch.slots
                ),
            )
            coll_schemas = {"emb": fused}
            coll_schemas.update(
                {k: v for k, v in schemas.items() if k not in ("wide", "emb")}
            )
        else:
            coll_schemas = schemas
        self.collections = {
            name: EmbeddingCollection(sch) for name, sch in coll_schemas.items()
        }
        self.sparse_opt = get_sparse_optimizer(self.sparse_optimizer)
        if self.table_strategy is None:
            self.table_strategy = LocalTables(self.collections, self.sparse_opt)
        elif callable(self.table_strategy) and not hasattr(self.table_strategy, "gather"):
            # factory: (collections, sparse_opt) -> strategy (parallel/)
            self.table_strategy = self.table_strategy(self.collections, self.sparse_opt)
        # bf16-compute models get their rows gathered directly in bf16 (the
        # cast fuses into the gather); the wide activation is upcast to f32
        # at the split (_forward_from_rows) so first-order sums keep f32
        # precision. Grads then reach the sparse optimizer in bf16, which
        # upcasts them (optim.apply_updates).
        self._gather_dtype = getattr(self.model, "compute_dtype", jnp.float32)
        lr = self.dense_lr_schedule if self.dense_lr_schedule is not None else self.dense_lr
        wd = self.dense_weight_decay
        if self.dense_optimizer == "adam":
            self.dense_tx = optax.adamw(lr, weight_decay=wd) if wd else optax.adam(lr)
        elif self.dense_optimizer == "adagrad":
            self.dense_tx = optax.adagrad(lr)
        elif self.dense_optimizer == "sgd":
            self.dense_tx = optax.sgd(lr)
        else:
            raise ValueError(f"unknown dense optimizer {self.dense_optimizer}")
        if wd and self.dense_optimizer != "adam":
            # decoupled decay for non-adam: decay folded in BEFORE the update
            self.dense_tx = optax.chain(
                optax.add_decayed_weights(wd), self.dense_tx
            )

    # ------------------------------------------------------------------ init
    def init(self, rng: jax.Array) -> TrainState:
        r_dense, r_emb = jax.random.split(rng)
        dense_params = self.model.init_dense(r_dense)
        emb_params = self.table_strategy.init_params(r_emb)
        if self._fused_wide:
            # the fused wide column starts at zero (LR/FM linear-term init)
            emb_params["emb"] = {
                g: t.at[:, -1].set(0.0) for g, t in emb_params["emb"].items()
            }
        return TrainState(
            step=jnp.zeros((), jnp.int32),
            dense_params=dense_params,
            dense_opt=self.dense_tx.init(dense_params),
            emb_params=emb_params,
            emb_opt=self.table_strategy.init_opt(),
        )

    # ------------------------------------------------------------- forward
    def _group_ids(self, ids: jnp.ndarray):
        """Per-collection global row ids, SHARING the actual arrays between
        collections whose groups are identical (e.g. 'wide' and 'emb' over
        the same vocab layout). Returning the same traced array lets XLA CSE
        the downstream dedup sort once instead of per collection."""
        cache: dict = {}
        out = {}
        for name, coll in self.collections.items():
            per_group = {}
            for g in coll.groups:
                key = (g.slot_indices, g.row_offsets)
                if key not in cache:
                    cache[key] = coll.group_row_ids(ids)[g.name]
                per_group[g.name] = cache[key]
            out[name] = per_group
        return out

    def _forward_from_rows(self, dense_params, rows, dense):
        emb = {name: coll.combine(rows[name]) for name, coll in self.collections.items()}
        if self._fused_wide:
            full = emb.pop("emb")  # [B, slots, D+1]
            if hasattr(self.model, "apply_fused_rows"):
                # model consumes the fused [B, slots, D+1] rows directly
                return self.model.apply_fused_rows(dense_params, dense, full)
            emb["emb"] = full[..., : self._emb_dim]
            emb["wide"] = full[..., self._emb_dim :]
        if "wide" in emb:
            # first-order sums stay f32 even when rows are gathered bf16
            emb["wide"] = emb["wide"].astype(jnp.float32)
        return self.model.apply(dense_params, dense, emb)

    def logits(self, state: TrainState, dense: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
        """Inference forward pass."""
        gids = self._group_ids(ids)
        rows = self.table_strategy.gather(
            state.emb_params, gids, self._gather_dtype, state.emb_opt
        )
        out = self._forward_from_rows(state.dense_params, rows, dense)
        assert out.shape == (dense.shape[0],), out.shape  # see loss_fn guard
        return out

    # --------------------------------------------------------------- train
    def train_step(self, state: TrainState, dense, ids, labels):
        """One optimizer step. Returns (new_state, {'loss': mean_bce,
        'overflow': dropped-lookup count — nonzero only with sharded tables
        whose capacity_factor is undersized; surfaced so Trainer can log it
        instead of silently training on zero rows})."""
        gids = self._group_ids(ids)
        rows, overflow = self.table_strategy.gather(
            state.emb_params, gids, self._gather_dtype, state.emb_opt,
            with_stats=True,
        )

        def loss_fn(dense_params, rows):
            logits = self._forward_from_rows(dense_params, rows, dense)
            # trace-time guard: a (B, 1)-shaped term broadcast against [B]
            # terms silently builds (B, B) logits (an earlier fanout bug)
            assert logits.shape == labels.shape, (logits.shape, labels.shape)
            losses = optax.sigmoid_binary_cross_entropy(logits, labels)
            return jnp.mean(losses)

        loss, (g_dense, g_rows) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            state.dense_params, rows
        )
        if self.axis_name is not None:
            loss = jax.lax.pmean(loss, self.axis_name)
            overflow = jax.lax.psum(overflow, self.axis_name)
            g_dense = jax.lax.pmean(g_dense, self.axis_name)
            # Embedding grads are summed per-row at the owning shard across
            # ALL devices' occurrences, so the per-example weight must be
            # 1/global_batch, not 1/local_batch — rescale by 1/axis_size.
            # (Dense grads instead go through pmean above.)
            inv = 1.0 / jax.lax.axis_size(self.axis_name)
            g_rows = jax.tree.map(lambda g: g * inv, g_rows)

        updates, dense_opt = self.dense_tx.update(g_dense, state.dense_opt, state.dense_params)
        dense_params = optax.apply_updates(state.dense_params, updates)

        lr = (
            self.emb_lr_schedule(state.step)
            if self.emb_lr_schedule is not None
            else jnp.asarray(self.emb_lr, jnp.float32)
        )
        emb_params, emb_opt = self.table_strategy.apply_grads(
            state.emb_params, state.emb_opt, gids, g_rows, state.step, lr
        )
        new_state = TrainState(
            step=state.step + 1,
            dense_params=dense_params,
            dense_opt=dense_opt,
            emb_params=emb_params,
            emb_opt=emb_opt,
        )
        return new_state, {"loss": loss, "overflow": overflow}

    # ------------------------------------------------- gradient accumulation
    def train_step_accum(self, state: TrainState, dense, ids, labels):
        """One optimizer step from A accumulated micro-batches (SURVEY.md
        §2c "optional batch-split accumulation"; the reference's per-core
        replica pre-aggregation shape). dense [A, Bm, F], ids [A, Bm, S],
        labels [A, Bm]: forward/backward runs per micro-batch (peak
        activation memory is ONE micro-batch — XLA chains the unrolled
        iterations through the accumulators), gradients average across
        micro-batches, then BOTH optimizers apply once. Numerically this
        equals train_step on the concatenated [A·Bm] batch up to f32
        summation order: dense grads are means-of-means (equal micro
        sizes), and the embedding update sees the CONCATENATED id/grad
        stream — the same duplicate-sum semantics."""
        a = dense.shape[0]
        g_dense_acc = None
        loss_acc = 0.0
        overflow_acc = jnp.zeros((), jnp.int32)
        rows_grads = []
        gids_list = []
        for i in range(a):  # static unroll: A is small (2-8)
            gids = self._group_ids(ids[i])
            rows, overflow = self.table_strategy.gather(
                state.emb_params, gids, self._gather_dtype, state.emb_opt,
                with_stats=True,
            )
            overflow_acc = overflow_acc + overflow

            def loss_fn(dense_params, rows, i=i):
                logits = self._forward_from_rows(dense_params, rows, dense[i])
                assert logits.shape == labels[i].shape
                return jnp.mean(
                    optax.sigmoid_binary_cross_entropy(logits, labels[i])
                )

            loss, (g_dense, g_rows) = jax.value_and_grad(
                loss_fn, argnums=(0, 1)
            )(state.dense_params, rows)
            loss_acc = loss_acc + loss
            g_dense_acc = (
                g_dense
                if g_dense_acc is None
                else jax.tree.map(jnp.add, g_dense_acc, g_dense)
            )
            gids_list.append(gids)
            rows_grads.append(g_rows)
        inv_a = 1.0 / a
        loss = loss_acc * inv_a
        g_dense = jax.tree.map(lambda g: g * inv_a, g_dense_acc)
        # concatenate the micro-batches' id/grad streams along the batch
        # axis; grads scale by 1/A so per-row sums match the full-batch mean
        gids_cat = jax.tree.map(
            lambda *xs: jnp.concatenate(xs, axis=0), *gids_list
        )
        g_rows_cat = jax.tree.map(
            lambda *xs: jnp.concatenate(xs, axis=0) * inv_a, *rows_grads
        )
        if self.axis_name is not None:
            loss = jax.lax.pmean(loss, self.axis_name)
            overflow_acc = jax.lax.psum(overflow_acc, self.axis_name)
            g_dense = jax.lax.pmean(g_dense, self.axis_name)
            inv = 1.0 / jax.lax.axis_size(self.axis_name)
            g_rows_cat = jax.tree.map(lambda g: g * inv, g_rows_cat)
        updates, dense_opt = self.dense_tx.update(
            g_dense, state.dense_opt, state.dense_params
        )
        dense_params = optax.apply_updates(state.dense_params, updates)
        lr = (
            self.emb_lr_schedule(state.step)
            if self.emb_lr_schedule is not None
            else jnp.asarray(self.emb_lr, jnp.float32)
        )
        emb_params, emb_opt = self.table_strategy.apply_grads(
            state.emb_params, state.emb_opt, gids_cat, g_rows_cat,
            state.step, lr,
        )
        new_state = TrainState(
            step=state.step + 1,
            dense_params=dense_params,
            dense_opt=dense_opt,
            emb_params=emb_params,
            emb_opt=emb_opt,
        )
        # overflow summed over micro-batches (one optimizer step's total
        # dropped lookups — it was silently dropped)
        return new_state, {"loss": loss, "overflow": overflow_acc}

    def jit_train_step_accum(self, donate: bool = True):
        return jax.jit(self.train_step_accum, donate_argnums=(0,) if donate else ())

    def train_scan_accum(self, state: TrainState, dense, ids, labels):
        """K accumulated steps in one program: batches stacked
        [K, A, Bm, ...]; each scan iteration is one ``train_step_accum``."""

        def body(st, batch):
            d, i, l = batch
            st, m = self.train_step_accum(st, d, i, l)
            return st, (m["loss"], m["overflow"])

        state, (losses, overflows) = jax.lax.scan(body, state, (dense, ids, labels))
        return state, {
            "loss": losses[-1],
            "losses": losses,
            "overflow": jnp.max(overflows),
        }

    def jit_train_scan_accum(self, donate: bool = True):
        return jax.jit(self.train_scan_accum, donate_argnums=(0,) if donate else ())

    # ----------------------------------------------------------- multi-step
    def train_scan(self, state: TrainState, dense, ids, labels):
        """K steps in ONE XLA program via lax.scan (dense/ids/labels stacked
        [K, B, ...]). Amortizes host dispatch: one launch per K steps, fed
        from a device-resident superbatch."""

        def body(st, batch):
            d, i, l = batch
            st, m = self.train_step(st, d, i, l)
            return st, (m["loss"], m["overflow"])

        state, (losses, overflows) = jax.lax.scan(body, state, (dense, ids, labels))
        return state, {
            "loss": losses[-1],
            "losses": losses,
            "overflow": jnp.max(overflows),
        }

    def jit_train_scan(self, donate: bool = True):
        return jax.jit(self.train_scan, donate_argnums=(0,) if donate else ())

    def train_scan_gen(self, state: TrainState, step0, *, k: int, batch_fn):
        """K steps whose batches are GENERATED in-graph by ``batch_fn(i)``
        (data/device_synth.py): no host producer, no host->device bytes —
        the loop runs at pure device rate. ``step0``: global batch index of
        the first step (traced; resume-compatible cursor)."""

        def body(st, i):
            d, ids, l = batch_fn(i)
            st, m = self.train_step(st, d, ids, l)
            return st, (m["loss"], m["overflow"])

        state, (losses, overflows) = jax.lax.scan(
            body, state, step0 + jnp.arange(k, dtype=jnp.int32)
        )
        return state, {
            "loss": losses[-1],
            "losses": losses,
            "overflow": jnp.max(overflows),
        }

    # ---------------------------------------------------------------- eval
    def eval_step(self, state: TrainState, auc_state, dense, ids, labels):
        logits = self.logits(state, dense, ids)
        if self.axis_name is not None:
            # histogram state is additive -> psum-merge across devices
            new = metrics_lib.auc_update(metrics_lib.auc_init(auc_state.pos_hist.shape[0]), logits, labels)
            new = jax.tree.map(lambda x: jax.lax.psum(x, self.axis_name), new)
            return metrics_lib.auc_merge(auc_state, new)
        return metrics_lib.auc_update(auc_state, logits, labels)

    # ------------------------------------------------------------- jitting
    def jit_train_step(self, donate: bool = True):
        return jax.jit(self.train_step, donate_argnums=(0,) if donate else ())

    def jit_eval_step(self):
        return jax.jit(self.eval_step, donate_argnums=(1,))
