"""Test harness: 8 virtual CPU devices (SURVEY.md §4 item 3 — JAX's analog of
Spark's local[K]: the full shard_map/all_to_all/psum path runs unmodified on
fake devices).

The tests run on the CPU only. The on-card check is ``python chip_smoke.py``
(README), run on a machine with an NVIDIA GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
