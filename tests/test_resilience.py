"""Failure-recovery drill (SURVEY.md §5.3): SIGKILL a training process
mid-run, restart it, and require the final state to be byte-identical to an
uninterrupted run. This exercises the real preemption path — process death,
orbax restore, data-cursor restore — not just in-process restore."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from recmodels.utils.config import TrainConfig
from recmodels.train.loop import Trainer

ckpt, steps = sys.argv[1], int(sys.argv[2])
cfg = TrainConfig(model="fm", vocab_size=300, embed_dim=8, batch_size=64,
                  steps=steps, log_every=10, eval_every=0, emb_lr=5e-2,
                  n_devices=1, ckpt_dir=ckpt, ckpt_every=5)
t = Trainer(cfg)
t.run()
# dump final params fingerprint
leaves = jax.tree.leaves(t.state)
np.save(ckpt + "/final.npy", np.concatenate([np.asarray(l).ravel() for l in leaves]))
print("FINISHED")
"""


def _run(ckpt, steps, kill_after=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = "/root/repo"
    p = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, ckpt, str(steps)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        env=env,
        cwd="/root/repo",
    )
    if kill_after is not None:
        # wait until some checkpoints exist, then kill hard
        deadline = time.time() + 120
        while time.time() < deadline:
            if os.path.isdir(ckpt) and any(d.isdigit() and int(d) >= kill_after for d in os.listdir(ckpt)):
                break
            time.sleep(0.2)
        p.kill()
        p.wait()
        return None
    out, _ = p.communicate(timeout=300)
    assert b"FINISHED" in out, out.decode()[-2000:]
    return out


@pytest.mark.slow
def test_sigkill_resume_identical(tmp_path):
    a = str(tmp_path / "uninterrupted")
    b = str(tmp_path / "killed")
    _run(a, 30)
    _run(b, 30, kill_after=10)  # killed once some ckpt >= step 10 exists
    assert not os.path.exists(b + "/final.npy")  # really died early
    _run(b, 30)  # restart; resumes from last checkpoint
    fa = np.load(a + "/final.npy")
    fb = np.load(b + "/final.npy")
    np.testing.assert_array_equal(fa, fb)
