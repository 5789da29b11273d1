"""Multi-host initialization and cross-host conventions.

The reference's MPI support was removed years ago (the fossil
`MpiMcmcApplication` name — SURVEY.md §2.4); here multi-host is
first-class but thin: `jax.distributed.initialize` wires the hosts, the
global device list feeds the same (chains x stars) mesh, and every
collective in the samplers/SMC rides XLA's own collectives (NCCL on
GPUs) — no custom transport (SURVEY.md §5 comm backend).

Usage on each host:

    from base_tpu.parallel import distributed, mesh
    distributed.initialize("host0:1234", num_processes=2, process_id=i)
    m = mesh.make_mesh(n_star_shards=2)   # spans ALL hosts' devices
    # samplers/SMC shard_map over m exactly as single-host

Checkpoint/resume across hosts: give each process its own checkpoint
path (io.checkpoint writes one npz file); on coordinator failure,
restart all processes and resume.
"""
from __future__ import annotations

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed.  Nothing discovers a GPU cluster on
    its own: pass the coordinator address, process count and this
    process's id."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def is_initialized() -> bool:
    try:
        return jax.process_count() > 1 or jax._src.distributed.global_state.client is not None
    except Exception:
        return False


def process_info() -> dict:
    return dict(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_devices=len(jax.local_devices()),
        global_devices=len(jax.devices()),
    )
