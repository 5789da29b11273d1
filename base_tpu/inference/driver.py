"""Checkpointed sampling driver: chunked HMC with save/resume.

Failure recovery for long runs (SURVEY.md §5 "failure detection /
checkpoint-resume" — absent in the reference): sampling proceeds in
host-level chunks of a jitted `sample_chunk`; after each chunk the full
run state (chain states incl. RNG keys, mass matrix, step size, the
preallocated sample store and the chunk cursor) is saved atomically.  A
re-launched run restores and continues; because chunk boundaries carry
the exact RNG keys, an interrupted+resumed run is bit-identical to an
uninterrupted one.

`run_checkpointed` is sampler-agnostic: it drives any (warm, step) pair
with the HMC state contract, so the single-device path
(run_hmc_checkpointed) and the shard_map path
(parallel.run.run_hmc_sharded_checkpointed) share one resume loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from base_tpu.inference import hmc as hmc_mod
from base_tpu.io import checkpoint as ckpt


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    checkpoint_path: str | None = None
    chunk_size: int = 100        # recorded samples per chunk
    checkpoint_every: int = 1    # chunks between saves
    on_window: Callable | None = None   # (chunk_idx, zs, lps) stream hook


def run_checkpointed(
    warm: Callable,   # (init_z, key) -> (chain_states, inv_mass, eps)
    step: Callable,   # (states, inv_mass, eps) -> (states, zs [C,n,P], lps, aps)
    init_z: Array,    # [C, P]
    key: Array,
    cfg: hmc_mod.HMCConfig,
    dcfg: DriverConfig = DriverConfig(),
):
    """Chunked warm+sample loop with atomic checkpoints and resume.

    Returns (samples [n_rec, C, P], info) exactly like run_hmc.  The
    chunk size also sets the streaming-diagnostics window: after every
    chunk, `dcfg.on_window(chunk_idx, zs, lps)` is called with the
    window's global samples (the in-run observability hook, SURVEY.md §5
    metrics plan).
    """
    C, P = init_z.shape
    n_rec = cfg.n_samples // cfg.thin
    n_chunks = max((n_rec + dcfg.chunk_size - 1) // dcfg.chunk_size, 1)
    chunk = max(min(dcfg.chunk_size, n_rec), 1)

    def fresh_store():
        states, inv_mass, eps = warm(init_z, key)
        return dict(
            chain_state=states,
            inv_mass=inv_mass,
            eps=eps,
            samples=jnp.zeros((n_chunks * chunk, C, P)),
            logposts=jnp.zeros((n_chunks * chunk, C)),
            accepts=jnp.zeros((n_chunks * chunk, C)),
            cursor=jnp.zeros((), jnp.int32),
        )

    store = None
    if dcfg.checkpoint_path and ckpt.checkpoint_exists(dcfg.checkpoint_path):
        like = jax.tree_util.tree_map(np.asarray, fresh_store())
        store = ckpt.restore_checkpoint(dcfg.checkpoint_path, like)
        store = jax.tree_util.tree_map(jnp.asarray, store)
    if store is None:
        store = fresh_store()

    start = int(store["cursor"])
    for ci in range(start, n_chunks):
        states, zs, lps, aps = step(
            store["chain_state"], store["inv_mass"], store["eps"]
        )
        lo = ci * chunk
        store["chain_state"] = states
        zs_t = jnp.swapaxes(zs, 0, 1)   # [n, C, P]
        lps_t = jnp.swapaxes(lps, 0, 1)
        store["samples"] = jax.lax.dynamic_update_slice(
            store["samples"], zs_t, (lo, 0, 0)
        )
        store["logposts"] = jax.lax.dynamic_update_slice(
            store["logposts"], lps_t, (lo, 0)
        )
        # Per-draw accepts [n, C] so the final mean can truncate to the
        # recorded draws only — an uneven last chunk's over-run draws
        # must not skew the reported acceptance (the chunked runners
        # weight by recorded draws the same way).
        store["accepts"] = jax.lax.dynamic_update_slice(
            store["accepts"], jnp.swapaxes(aps, 0, 1), (lo, 0)
        )
        store["cursor"] = jnp.asarray(ci + 1, jnp.int32)
        if dcfg.checkpoint_path and (
            (ci + 1) % dcfg.checkpoint_every == 0 or ci + 1 == n_chunks
        ):
            ckpt.save_checkpoint(
                dcfg.checkpoint_path,
                jax.tree_util.tree_map(np.asarray, store),
            )
        if dcfg.on_window is not None:
            dcfg.on_window(ci, zs_t, lps_t)

    samples = store["samples"][:n_rec]
    info = dict(
        accept_prob=jnp.mean(store["accepts"][:n_rec]),
        step_size=store["eps"],
        inv_mass=store["inv_mass"],
        logposts=store["logposts"][:n_rec],
        final_states=store["chain_state"],
    )
    return samples, info


def make_hmc_chunked_runner(
    logpost_fn: Callable,
    cfg: hmc_mod.HMCConfig,
    chunk_draws: int = 256,
) -> Callable:
    """Host-chunked HMC: one device execution per warmup window plus
    bounded sampling-chunk executions.  Bit-identical to run_hmc (same
    RNG stream — verified by the warmup-parity test), but no single
    device execution runs longer than one window / one chunk: the chunk
    boundary is where checkpoints and streaming diagnostics attach
    (run_checkpointed).

    Returns `run(init_z, key, n_samples=None) -> (samples, info)` like
    run_hmc.  The jitted window/init/chunk programs live in THIS closure
    so repeated `run` calls (e.g. a bench warm pass then a timed pass)
    hit the compile cache — constructing them per call would retrace
    and recompile everything each time.

    When the chunk size does not divide the recorded-draw count, the
    last chunk still runs a full `chunk` draws: the recorded samples,
    logposts and accept_prob cover exactly the first n_rec draws, but
    `final_states` sits past run_hmc's terminal RNG position by the
    over-run (the bit-identity regression test pins the divisible case).
    """
    win = jax.jit(hmc_mod.make_warmup_window(logpost_fn, cfg))
    init_fn = jax.jit(
        lambda z, k: hmc_mod.init_chains(logpost_fn, z, k, cfg)
    )
    chunk = max(min(chunk_draws, cfg.n_samples // cfg.thin), 1)
    step = jax.jit(
        lambda st, im, e: hmc_mod.sample_chunk(
            logpost_fn, st, im, e, chunk, cfg
        )
    )

    def run(init_z: Array, key: Array, n_samples: int | None = None,
            inv_mass0: Array | None = None):
        P = init_z.shape[-1]
        if inv_mass0 is None:
            inv_mass = jnp.eye(P) if cfg.dense_mass else jnp.ones((P,))
        else:
            # Warm-start metric (e.g. full-rank-VI covariance): window 0
            # adapts eps under it instead of the identity — required at
            # pod scale where the posterior is far tighter than the
            # identity metric's random walk can discover.
            inv_mass = jnp.asarray(inv_mass0)
        states = init_fn(init_z, key)
        for w in range(cfg.n_windows):
            states, inv_mass = win(states, inv_mass, jnp.asarray(w))
        eps = hmc_mod.freeze_step_size(states)

        n_rec = (cfg.n_samples if n_samples is None else n_samples) // cfg.thin
        n_chunks = (n_rec + chunk - 1) // chunk
        zs_all, lps_all, aps_all = [], [], []
        for _ in range(n_chunks):
            states, zs, lps, aps = step(states, inv_mass, eps)
            zs_all.append(jnp.swapaxes(zs, 0, 1))
            lps_all.append(jnp.swapaxes(lps, 0, 1))
            aps_all.append(jnp.swapaxes(aps, 0, 1))   # [n, C]
        samples = jnp.concatenate(zs_all, axis=0)[:n_rec]
        info = dict(
            # Weighted by recorded draws: over-run draws of an uneven
            # last chunk do not enter the acceptance statistic.
            accept_prob=jnp.mean(jnp.concatenate(aps_all, axis=0)[:n_rec]),
            step_size=eps,
            inv_mass=inv_mass,
            logposts=jnp.concatenate(lps_all, axis=0)[:n_rec],
            final_states=states,
        )
        return samples, info

    return run


def run_hmc_chunked(
    logpost_fn: Callable,
    init_z: Array,   # [C, P]
    key: Array,
    cfg: hmc_mod.HMCConfig,
    chunk_draws: int = 256,
):
    """One-shot convenience wrapper over make_hmc_chunked_runner."""
    return make_hmc_chunked_runner(logpost_fn, cfg, chunk_draws)(init_z, key)


def run_hmc_checkpointed(
    logpost_fn: Callable,
    init_z: Array,   # [C, P]
    key: Array,
    cfg: hmc_mod.HMCConfig,
    dcfg: DriverConfig = DriverConfig(),
):
    """Single-device HMC with periodic checkpointing and automatic
    resume.  Returns (samples [n_rec, C, P], info) like run_hmc."""
    n_rec = cfg.n_samples // cfg.thin
    chunk = max(min(dcfg.chunk_size, n_rec), 1)

    def warm(z, k):
        # Per-window device executions (see run_hmc_chunked) —
        # bit-identical to one-shot hmc.warmup.
        P = z.shape[-1]
        states = jax.jit(
            lambda zz, kk: hmc_mod.init_chains(logpost_fn, zz, kk, cfg)
        )(z, k)
        win = jax.jit(hmc_mod.make_warmup_window(logpost_fn, cfg))
        inv_mass = jnp.eye(P) if cfg.dense_mass else jnp.ones((P,))
        for w in range(cfg.n_windows):
            states, inv_mass = win(states, inv_mass, jnp.asarray(w))
        return states, inv_mass, hmc_mod.freeze_step_size(states)

    step = jax.jit(
        lambda st, im, eps: hmc_mod.sample_chunk(
            logpost_fn, st, im, eps, chunk, cfg
        )
    )
    return run_checkpointed(warm, step, init_z, key, cfg, dcfg)
