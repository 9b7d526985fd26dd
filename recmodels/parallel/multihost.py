"""Multi-host initialization (SURVEY.md §3.5: the equivalent of the
reference's spark-submit + Engine.init deployment layer).

Each host runs this same program; ``initialize()`` wires them into one JAX
runtime (one global device set), after which the mesh in parallel/mesh.py
spans all devices and shard_map/all_to_all become cross-host collectives.
Data is fed per-host: host h reads shard h of the input (``host_shard()``
plugs into the data sources' shard_index/shard_count).

No cluster manager, scheduler, or transport code exists here on purpose:
collectives are XLA's, and elasticity follows the gang-scheduled model
(SURVEY.md §5.3) — preemption is handled by checkpoint/resume, not by
surviving with fewer devices.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Idempotent jax.distributed init. With no args, uses JAX's cluster
    auto-detection; where no cluster is detected, pass the coordinator
    address, process count and id explicitly.

    Failure policy: when the caller EXPLICITLY asks
    for a multi-process topology (any argument given, or num_processes>1),
    a failed init raises — silently degrading a mis-configured pod to
    single-process training would train on 1/N of the data with no error.
    Only the zero-config probe ("am I in a pod environment?") is allowed
    to fall back to single-process."""
    if jax.process_count() > 1:
        return  # already initialized
    explicit = (coordinator_address is not None or process_id is not None
                or (num_processes or 0) > 1)
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError) as e:
        if explicit:
            raise RuntimeError(
                f"multi-process init failed for an explicitly requested "
                f"topology (coordinator={coordinator_address}, "
                f"n={num_processes}, id={process_id})"
            ) from e
        # zero-config single-process run (no coordinator) — fine.


def host_shard() -> tuple[int, int]:
    """(shard_index, shard_count) for per-host data sharding."""
    return jax.process_index(), jax.process_count()


def is_primary() -> bool:
    """True on the host that should write checkpoints metadata/TB logs."""
    return jax.process_index() == 0
