"""The entry points' compile cache and their independence from orbax."""

import os
import shutil
import subprocess
import sys

import pytest

from recmodels.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# train.py as a script, with orbax hidden; prints the cache dir JAX used
_HIDDEN_ORBAX_TRAIN = """
import runpy, sys
sys.modules["orbax"] = None
sys.argv = ["train.py", "--model", "deepfm", "--steps", "5", "--cpu",
            "--batch-size", "64", "--set", "vocab_size=500", "--set", "eval_every=5",
            "--set", "eval_batches=1", "--set", "producer_workers=1"]
try:
    runpy.run_path("train.py", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
import jax
print("CACHE_DIR", jax.config.jax_compilation_cache_dir)
"""


def _train_without_orbax(checkout, env_cache):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_cache is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_cache)
    proc = subprocess.run([sys.executable, "-c", _HIDDEN_ORBAX_TRAIN], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done:" in proc.stdout
    return proc.stdout.split("CACHE_DIR ")[-1].strip()


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_train_cli_without_orbax_caches_in_env_dir(tmp_path):
    cache = tmp_path / "cache"
    assert _train_without_orbax(REPO, cache) == str(cache)
    assert any(cache.iterdir())  # compiled programs landed there


def test_train_cli_without_orbax_caches_in_checkout(tmp_path):
    """A copy of the checkout, so the default cache starts empty."""
    ignore = shutil.ignore_patterns("__pycache__", "_build")
    shutil.copytree(os.path.join(REPO, "recmodels"), tmp_path / "recmodels", ignore=ignore)
    shutil.copy(os.path.join(REPO, "train.py"), tmp_path)
    cache = tmp_path / ".jax_cache"
    assert _train_without_orbax(tmp_path, None) == str(cache)
    assert any(cache.iterdir())


def test_checkpoint_manager_names_missing_orbax(monkeypatch, tmp_path):
    from recmodels.train.checkpoint import CheckpointManager

    monkeypatch.setitem(sys.modules, "orbax", None)
    with pytest.raises(ImportError, match="orbax"):
        CheckpointManager(str(tmp_path))


def test_trainer_with_ckpt_dir_fails_at_start_without_orbax(monkeypatch, tmp_path):
    from recmodels.train.loop import Trainer
    from recmodels.utils.config import TrainConfig

    monkeypatch.setitem(sys.modules, "orbax", None)
    cfg = TrainConfig(model="lr", vocab_size=100, n_devices=1, ckpt_dir=str(tmp_path))
    with pytest.raises(ImportError, match="orbax-checkpoint"):
        Trainer(cfg)
