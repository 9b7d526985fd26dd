"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its phase
functions work end to end at tiny sizes (the card runs them at full width)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from bench import MODEL_KW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=500, embed_dim=8, cin_sizes=(8, 8), hidden=(16, 16))


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _refused(proc):
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU found" in proc.stderr


def test_refuses_cpu_only_run():
    _refused(_run_smoke(REPO))


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    _refused(_run_smoke(tmp_path))


@pytest.mark.parametrize("name", sorted(MODEL_KW))
def test_zoo_phase(name):
    losses = chip_smoke.phase_zoo([name], 500, 8, lambda n: 64)
    assert len(losses[name]) == 3


@pytest.fixture(scope="module")
def trainer():
    cfg = chip_smoke.flagship_config(batch_size=512, producer_workers=1, **TINY)
    return chip_smoke.phase_train(cfg)


def test_train_phase_loss_falls(trainer):
    assert int(trainer.state.step) == chip_smoke.TRAIN_STEPS


def test_serve_phase_bit_exact(trainer):
    chip_smoke.phase_serve(trainer, sizes=(1, 10, 100, 300), min_bucket=16)


def test_parity_phase():
    cpu = jax.devices("cpu")[0]
    chip_smoke.phase_parity(500, 8, 64, (8, 8), (16,), cpu, cpu)


def test_timing_phase(capsys):
    chip_smoke.phase_timing(500, 8, 64, (8, 8), (16,), 1, "n/a", "cpu",
                            ref_n=64, ref_bytes=1 << 20)
    out = capsys.readouterr().out
    for what in ("cin fwd+bwd", "gather", "adagrad update", "train step"):
        assert what in out
    assert "roofline not measured" in out  # no published peak for a CPU


def test_four_cards_phase_on_virtual_devices(capsys):
    cfg = chip_smoke.flagship_config(bf16=False, n_devices=4, batch_size=128,
                                     capacity_factor=4.0, **TINY)
    chip_smoke.phase_four_cards(cfg)
    assert "overflow=0" in capsys.readouterr().out


def test_four_cards_phase_fails_on_overflow():
    cfg = chip_smoke.flagship_config(bf16=False, n_devices=4, batch_size=128,
                                     capacity_factor=0.1, **TINY)
    with pytest.raises(RuntimeError, match="overflowed"):
        chip_smoke.phase_four_cards(cfg)
