"""Device-mesh construction for chain/star sharding.

The reference's only parallelism is a CPU thread pool over stars inside
one process [upstream: base9/Utility.hpp thread pool — SURVEY.md C15,
§2.4].  Here the layout is a 2-D logical mesh:

  axis "chains" — data-parallel axis: independent MCMC chains / SMC
                  particle blocks (the DP analog);
  axis "stars"  — the long-reduction axis: the per-star log-likelihood
                  sum is sharded so no device ever holds all stars' [S, T]
                  workspace (the sequence-parallel / ring-attention
                  analog, SURVEY.md §2.4).

Collectives: likelihood partial sums ride `psum` over "stars";
mass-matrix pooling, step-size pooling and R-hat/ESS ride
`psum`/`all_gather` over "chains", which XLA hands to NCCL on GPUs.
The mesh is logical: the cards of one host are joined all to all
(NVLink), so its shape follows the algorithm alone.  Multi-host:
`jax.distributed` initializes the global device list and the same mesh
spans hosts.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

CHAIN_AXIS = "chains"
STAR_AXIS = "stars"


def make_mesh(
    n_chain_shards: int | None = None,
    n_star_shards: int = 1,
    devices=None,
) -> Mesh:
    """Build the (chains x stars) mesh over `devices` (default: all).

    n_chain_shards defaults to n_devices / n_star_shards.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_chain_shards is None:
        if n % n_star_shards:
            raise ValueError(f"{n} devices not divisible by {n_star_shards}")
        n_chain_shards = n // n_star_shards
    if n_chain_shards * n_star_shards != n:
        raise ValueError(
            f"mesh {n_chain_shards}x{n_star_shards} != {n} devices"
        )
    arr = np.asarray(devices).reshape(n_chain_shards, n_star_shards)
    return Mesh(arr, (CHAIN_AXIS, STAR_AXIS))


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n."""
    return ((n + k - 1) // k) * k
