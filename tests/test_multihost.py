"""Multi-HOST smoke (SURVEY.md §4 item 3 'multi-host logic additionally
testable with jax.distributed multi-process on localhost'): two real
processes, one CPU device each, full sharded train step over the 2-process
mesh — collectives actually cross a process boundary (TCP), unlike the
8-fake-device tests."""

import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import sys
import jax

coord, pid = sys.argv[1], int(sys.argv[2])
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 2  # one cpu device per process

import jax.numpy as jnp
from recmodels.data import SyntheticSource, criteo_schema
from recmodels.models import build_model
from recmodels.parallel import (build_parallel_engine, build_parallel_steps,
                                    make_mesh, shard_state)
from recmodels.parallel.multihost import host_shard

sch = criteo_schema(vocab_size=400, embed_dim=8)
mesh = make_mesh()  # both devices, both processes
eng = build_parallel_engine(build_model("fm", sch), mesh, emb_lr=5e-2, capacity_factor=4.0)
state = shard_state(eng.init(jax.random.key(0)), mesh)
train, _ = build_parallel_steps(eng, mesh)

# global batch assembled per-host: each process feeds its own shard via
# jax.make_array_from_process_local_data
from jax.sharding import NamedSharding, PartitionSpec as P
import numpy as np

h_idx, h_cnt = host_shard()
src = SyntheticSource(sch, batch_size=32, seed=0, shard_index=h_idx, shard_count=h_cnt)
it = iter(src)
sharding = NamedSharding(mesh, P("data"))
losses = []
for i in range(3):
    b = next(it)
    args = tuple(
        jax.make_array_from_process_local_data(sharding, np.asarray(x))
        for x in (b.dense, b.ids, b.labels)
    )
    state, m = train(state, *args)
    losses.append(float(m["loss"]))
print("WORKER_OK", pid, [round(l, 4) for l in losses])
"""


@pytest.mark.slow
def test_two_process_sharded_training():
    port = None
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    # drop the fake-device flag inherited from conftest: each process should
    # contribute exactly one real CPU device to the global mesh
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split() if "host_platform_device_count" not in f
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, coord, str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            cwd="/root/repo",
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out.decode())
    for i, out in enumerate(outs):
        assert f"WORKER_OK {i}" in out, f"worker {i} failed:\n{out[-3000:]}"
    # both processes computed the same (psum'd) loss sequence
    l0 = [l for l in outs[0].splitlines() if "WORKER_OK" in l][0].split("[")[1]
    l1 = [l for l in outs[1].splitlines() if "WORKER_OK" in l][0].split("[")[1]
    assert l0 == l1


TRAINER_WORKER = r"""
import json
import sys

import jax

coord, pid, ckpt_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2

import jax.numpy as jnp
from recmodels.train.loop import Trainer
from recmodels.utils.config import TrainConfig

cfg = TrainConfig(model="fm", vocab_size=400, embed_dim=8, batch_size=32,
                  steps=6, scan_steps=2, eval_every=3, eval_batches=2,
                  log_every=2, dense_lr=1e-2, emb_lr=5e-2,
                  capacity_factor=4.0, ckpt_dir=ckpt_dir, ckpt_every=3,
                  seed=0)
tr = Trainer(cfg)
final = tr.run()
state = tr.state


def sums(st):
    d = float(sum(jnp.sum(jnp.abs(x)) for x in jax.tree_util.tree_leaves(st.dense_params)))
    e = float(jnp.sum(jnp.abs(st.emb_params["emb"]["d9"])))
    return round(d, 5), round(e, 3)


d_sum, e_sum = sums(state)
print("WORKER_OK", pid, json.dumps({
    "step": int(state.step), "d": d_sum, "e": e_sum,
    "auc": round(float(final["auc"]), 5),
    "logloss": round(float(final["logloss"]), 5),
}))

# checkpoint restore drill on the product manager (multi-process orbax)
tr2 = Trainer(cfg)
st2 = tr2._shard(tr2.engine.init(jax.random.key(cfg.seed)))
st2, data = tr2.ckpt.restore(st2)
d2, e2 = sums(st2)
print("RESTORE_OK", pid, json.dumps({"step": int(st2.step), "d": d2, "e": e2}))
"""


@pytest.mark.slow
def test_two_process_trainer_product_path(tmp_path):
    """the 2-process lane drives the PRODUCT path —
    Trainer.run with per-host data shards, _put's
    make_array_from_process_local_data, primary-only TB/ckpt metadata, the
    scan superbatch path, one eval, and a checkpoint save+restore — and the
    result must match a 1-process oracle consuming the same global batches
    on a 2-fake-device mesh."""
    import json

    port = None
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    ckpt_dir = str(tmp_path / "mh_ckpt")
    env = dict(os.environ)
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split() if "host_platform_device_count" not in f
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", TRAINER_WORKER, coord, str(i), ckpt_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd="/root/repo",
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())

    def line(tag, out):
        ls = [l for l in out.splitlines() if l.startswith(tag)]
        assert ls, f"no {tag} in:\n{out[-3000:]}"
        return json.loads(ls[0].split(None, 2)[2])

    w0, w1 = (line("WORKER_OK", o) for o in outs)
    r0, r1 = (line("RESTORE_OK", o) for o in outs)
    assert w0 == w1, (w0, w1)  # identical global state on both processes
    assert w0["step"] == 6
    # restored state matches the live final state (force-saved at step 6)
    for r in (r0, r1):
        assert r == {"step": w0["step"], "d": w0["d"], "e": w0["e"]}, (r, w0)

    # ---- 1-process oracle: same global batches on a 2-fake-device mesh ----
    import numpy as np
    import jax
    import jax.numpy as jnp
    from recmodels.data import SyntheticSource, criteo_schema
    from recmodels.models import build_model
    from recmodels.parallel import (
        build_parallel_engine, build_parallel_scan, build_parallel_steps,
        make_mesh, shard_state,
    )
    from recmodels.train import metrics as metrics_lib

    sch = criteo_schema(vocab_size=400, embed_dim=8)
    mesh = make_mesh(2)
    eng = build_parallel_engine(build_model("fm", sch), mesh,
                                dense_lr=1e-2, emb_lr=5e-2, capacity_factor=4.0)
    state = shard_state(eng.init(jax.random.key(0)), mesh)
    scan = build_parallel_scan(eng, mesh)
    _, eval_step = build_parallel_steps(eng, mesh, donate=False)
    its = [iter(SyntheticSource(sch, 32, seed=0, shard_index=i, shard_count=2))
           for i in (0, 1)]
    for _ in range(3):  # 3 superbatches of scan_steps=2 -> 6 steps
        steps = []
        for _ in range(2):
            b0, b1 = next(its[0]), next(its[1])
            steps.append(tuple(np.concatenate([x0, x1])
                               for x0, x1 in ((b0.dense, b1.dense),
                                              (b0.ids, b1.ids),
                                              (b0.labels, b1.labels))))
        xs = tuple(jnp.asarray(np.stack([s[j] for s in steps])) for j in range(3))
        state, m = scan(state, *xs)
    d_or = round(float(sum(jnp.sum(jnp.abs(x))
                           for x in jax.tree_util.tree_leaves(state.dense_params))), 5)
    e_or = round(float(jnp.sum(jnp.abs(state.emb_params["emb"]["d9"]))), 3)
    assert abs(d_or - w0["d"]) < 2e-3, (d_or, w0["d"])
    assert abs(e_or - w0["e"]) / max(abs(e_or), 1.0) < 1e-4, (e_or, w0["e"])
    # oracle eval on the same held-out shards
    vits = [iter(SyntheticSource(sch, 32, seed=0 + 7_777_777, shard_index=i,
                                 shard_count=2)) for i in (0, 1)]
    auc = metrics_lib.auc_init()
    for _ in range(2):
        b0, b1 = next(vits[0]), next(vits[1])
        auc = eval_step(state,
                        auc,
                        jnp.asarray(np.concatenate([b0.dense, b1.dense])),
                        jnp.asarray(np.concatenate([b0.ids, b1.ids])),
                        jnp.asarray(np.concatenate([b0.labels, b1.labels])))
    out = metrics_lib.auc_compute(auc)
    assert abs(float(out["auc"]) - w0["auc"]) < 1e-3, (out["auc"], w0["auc"])


KILL_WORKER = r"""
import hashlib
import os
import signal
import sys

import jax

coord, pid, ckpt_dir, kill_at = sys.argv[1], int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=coord, num_processes=2, process_id=pid)

import numpy as np
import jax.numpy as jnp
from recmodels.train.loop import Trainer
from recmodels.utils.config import TrainConfig

cfg = TrainConfig(model="fm", vocab_size=400, embed_dim=8, batch_size=32,
                  steps=8, scan_steps=1, eval_every=0, log_every=100,
                  dense_lr=1e-2, emb_lr=5e-2, capacity_factor=4.0,
                  ckpt_dir=ckpt_dir, ckpt_every=2, seed=0)
tr = Trainer(cfg)

if kill_at > 0 and pid == 1:
    # fault-injection hook (SURVEY.md par 5.3): SIGKILL THIS host process
    # mid-run, after `kill_at` optimizer steps have dispatched
    real_step = tr.train_step
    n = [0]
    def hooked(*a):
        if n[0] == kill_at:
            os.kill(os.getpid(), signal.SIGKILL)
        n[0] += 1
        return real_step(*a)
    tr.train_step = hooked

tr.run()
state = tr.state
h = hashlib.sha256()
for leaf in jax.tree_util.tree_leaves(state):
    # fully-addressable on a 2-process CPU mesh? tables are row-sharded:
    # hash the process-local shards plus replicated leaves deterministically
    arr = np.asarray(jax.device_get([s.data for s in leaf.addressable_shards][0])) \
        if hasattr(leaf, "addressable_shards") else np.asarray(leaf)
    h.update(arr.tobytes())
print("FINAL_HASH", pid, int(state.step), h.hexdigest())
"""


def _run_pair(worker, args_fn, timeout=300):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split() if "host_platform_device_count" not in f
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", worker, coord, str(i)] + args_fn(i),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd="/root/repo",
        )
        for i in range(2)
    ]
    return procs


@pytest.mark.slow
def test_two_process_kill_drill(tmp_path):
    """SURVEY.md §5.3: SIGKILL ONE host process
    mid-run (after 5 steps; async orbax checkpoints at steps 2/4 in
    flight), restart BOTH processes, resume, and the final state must be
    byte-identical to an unkilled control run — the multi-host extension of
    tests/test_resilience.py's single-process drill."""
    import time

    def hashes(procs, expect_fail=None):
        outs = []
        for i, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs.append(out.decode())
        res = {}
        for i, out in enumerate(outs):
            ls = [l for l in out.splitlines() if l.startswith("FINAL_HASH")]
            if not ls:
                assert expect_fail is not None and i in expect_fail, (
                    f"worker {i} produced no hash:\n{out[-3000:]}")
                continue
            _, wpid, step, dig = ls[0].split()
            res[int(wpid)] = (int(step), dig)
        return res

    # control: straight 8-step run
    ctrl = _run_pair(KILL_WORKER, lambda i: [str(tmp_path / "ctrl"), "0"])
    ctrl_h = hashes(ctrl)
    assert ctrl_h[0][0] == 8 and ctrl_h[1][0] == 8

    # faulted run: p1 SIGKILLs itself after 5 dispatched steps; p0 then
    # hangs in a collective — kill it once p1 is dead
    faulted = _run_pair(KILL_WORKER, lambda i: [str(tmp_path / "kill"), "5"])
    faulted[1].wait(timeout=300)
    assert faulted[1].returncode == -9  # SIGKILL'd itself
    time.sleep(2.0)
    faulted[0].kill()
    hashes(faulted, expect_fail={0, 1})

    # restart both processes on the SAME ckpt dir: resume + run to step 8
    resumed = _run_pair(KILL_WORKER, lambda i: [str(tmp_path / "kill"), "0"])
    res_h = hashes(resumed)
    assert res_h[0][0] == 8 and res_h[1][0] == 8
    # byte-identical final state per process rank vs the control
    assert res_h[0][1] == ctrl_h[0][1]
    assert res_h[1][1] == ctrl_h[1][1]
