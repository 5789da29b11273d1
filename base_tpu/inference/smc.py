"""Adaptive tempered SMC with systematic resampling — fully on-device.

The reference has no SMC; it is required by the north star
(BASELINE.json:5, pod config BASELINE.json:11) and is the natural
many-chips sampler: thousands of particles shard across the mesh like
chains do (SURVEY.md §2.4 "ring attention" row: all_gather of small
log-weights + gathered ancestry, never a host sync).

Algorithm (Del Moral et al. 2006 style):
  bridge      log pi_beta = (1-beta) log q0 + beta log target
  beta ladder chosen adaptively: each stage takes the largest step that
              keeps the incremental effective sample size above
              `ess_target` (fixed-iteration bisection — static shapes)
  resample    systematic, every stage, from the pooled weights
  move        n_move random-walk MH steps targeting pi_beta, proposal
              covariance = pooled particle covariance * 2.38^2/d

The whole run is one `lax.scan` over `max_stages`; stages after beta
reaches 1 are no-ops (masked), so the program is static regardless of
how many stages the adaptation actually uses.  With `axis_name` set the
same function runs under shard_map: weight statistics pool with psum,
and resampling all_gathers the (small) particle block.

Returns particles ~ target, plus the log normalizing-constant estimate
(log evidence) — a capability the reference never had.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from base_tpu.ops.special import NEG_INF


@dataclasses.dataclass(frozen=True)
class SMCConfig:
    n_particles: int = 1024     # per shard when sharded
    max_stages: int = 24
    n_move: int = 3
    ess_target: float = 0.6     # fraction of N
    n_bisect: int = 26
    move_scale: float = 1.0     # initial multiplier on 2.38^2/d
    # Move-kernel autotuning (VERDICT r3 #6: the committed artifact's
    # move acceptance sat at 0.13, below the 0.2-0.4 band where
    # random-walk moves mix): after each stage the proposal scale is
    # nudged log-multiplicatively toward `target_move_accept` — as the
    # tempered posterior narrows toward beta = 1, the scale follows.
    adapt_move: bool = True
    target_move_accept: float = 0.3
    move_adapt_rate: float = 1.0   # d log(scale) per unit accept error


class SMCState(NamedTuple):
    z: Array          # [N, P] particles
    log_target: Array # [N] log target density at z
    log_q0: Array     # [N] log reference density at z
    beta: Array       # scalar in [0, 1]
    log_evidence: Array
    log_move_scale: Array   # adapted log of the move-proposal multiplier
    key: Array


def _psum(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name else x


def _ess_fraction(log_w: Array, n_total: Array, axis_name) -> Array:
    """Effective sample size fraction of normalized weights exp(log_w)."""
    m = jnp.max(log_w)
    if axis_name:
        m = jax.lax.pmax(m, axis_name)
    w = jnp.exp(log_w - m)
    s1 = _psum(jnp.sum(w), axis_name)
    s2 = _psum(jnp.sum(w * w), axis_name)
    return (s1 * s1) / jnp.maximum(s2, 1e-38) / n_total


def _systematic_resample(key, log_w: Array, z: Array, axis_name):
    """Systematic resampling.  Sharded: all_gather weights AND particles
    (particle blocks are [N_local, P] — a few KB), pick the local slice
    of the global ancestry so every shard keeps N_local particles."""
    if axis_name:
        log_w_g = jax.lax.all_gather(log_w, axis_name).reshape(-1)
        z_g = jax.lax.all_gather(z, axis_name).reshape(-1, z.shape[-1])
        shard = jax.lax.axis_index(axis_name)
    else:
        log_w_g, z_g = log_w, z
        shard = 0
    N = log_w_g.shape[0]
    n_local = z.shape[0]
    m = jnp.max(log_w_g)
    w = jnp.exp(log_w_g - m)
    w = w / jnp.sum(w)
    cum = jnp.cumsum(w)
    # One shared uniform: fold the key identically on every shard.
    u = jax.random.uniform(key, ()) / N
    pts = u + jnp.arange(N) / N
    anc = jnp.searchsorted(cum, pts)          # [N] global ancestors
    anc = jnp.clip(anc, 0, N - 1)
    local = jax.lax.dynamic_slice_in_dim(anc, shard * n_local, n_local)
    return z_g[local]


def _smc_init(log_target, sample_q0, log_q0, key, cfg, axis_name):
    k_init, k_run = jax.random.split(key)
    z = sample_q0(k_init, cfg.n_particles)
    lt = jax.vmap(log_target)(z)
    lq = jax.vmap(log_q0)(z)
    n_total = jnp.asarray(cfg.n_particles, jnp.float32)
    if axis_name:
        n_total = jax.lax.psum(n_total, axis_name)
    state = SMCState(
        z=z, log_target=lt, log_q0=lq,
        beta=jnp.zeros(()), log_evidence=jnp.zeros(()),
        log_move_scale=jnp.log(jnp.asarray(cfg.move_scale, jnp.float32)),
        key=k_run,
    )
    return state, n_total


def _make_smc_stage(log_target, log_q0, cfg, axis_name, n_total, d):
    """One SMC stage as a pure (state) -> (state, (beta, acc, active))
    function — shared by the on-device lax.scan (run_smc) and the
    host-chunked runner (make_smc_chunked_runner, one device execution
    per stage)."""

    def stage(state: SMCState, _=None):
        done = state.beta >= 1.0
        # log weight increment for moving beta -> beta': (b'-b)(lt - lq)
        delta_l = state.log_target - state.log_q0
        delta_l = jnp.where(jnp.isfinite(delta_l), delta_l, NEG_INF)

        def ess_at(b_new):
            return _ess_fraction(
                (b_new - state.beta) * delta_l, n_total, axis_name
            )

        # Bisection for the largest step keeping ESS >= target.
        def bis(carry, _):
            lo, hi = carry
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= cfg.ess_target
            return (jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)), None

        full = ess_at(1.0) >= cfg.ess_target
        (lo, _), _ = jax.lax.scan(
            bis, (state.beta, jnp.ones(())), None, length=cfg.n_bisect
        )
        beta_new = jnp.where(full, 1.0, jnp.maximum(lo, state.beta + 1e-6))
        beta_new = jnp.where(done, state.beta, jnp.minimum(beta_new, 1.0))

        log_w = (beta_new - state.beta) * delta_l
        m = jnp.max(log_w)
        if axis_name:
            m = jax.lax.pmax(m, axis_name)
        lsum = jnp.log(_psum(jnp.sum(jnp.exp(log_w - m)), axis_name))
        log_ev_inc = m + lsum - jnp.log(n_total)

        key, k_res, k_mh = jax.random.split(state.key, 3)
        z_res = _systematic_resample(k_res, log_w, state.z, axis_name)

        # Pooled particle covariance for the move proposal (diagonal).
        s1 = _psum(jnp.sum(z_res, axis=0), axis_name)
        s2 = _psum(jnp.sum(z_res * z_res, axis=0), axis_name)
        mean = s1 / n_total
        var = jnp.maximum(s2 / n_total - mean * mean, 1e-10)
        scale = jnp.exp(state.log_move_scale)
        prop_sd = jnp.sqrt(var) * jnp.sqrt(scale * 2.38**2 / d)

        def bridge(zz):
            return (1.0 - beta_new) * log_q0(zz) + beta_new * log_target(zz)

        lb = jax.vmap(bridge)(z_res)

        def move(carry, k):
            z, lb = carry
            k1, k2 = jax.random.split(k)
            prop = z + prop_sd[None, :] * jax.random.normal(k1, z.shape)
            lb_p = jax.vmap(bridge)(prop)
            logu = jnp.log(jax.random.uniform(k2, (z.shape[0],)))
            acc = (logu < lb_p - lb) & (lb_p > NEG_INF / 2)
            z = jnp.where(acc[:, None], prop, z)
            lb = jnp.where(acc, lb_p, lb)
            return (z, lb), jnp.mean(acc.astype(jnp.float32))

        (z_new, _), accs = jax.lax.scan(
            move, (z_res, lb), jax.random.split(k_mh, cfg.n_move)
        )

        # Autotune the move scale toward the target acceptance (pooled
        # across shards so every shard keeps an identical, replicated
        # scale — proposals stay lockstep-consistent with the pooled
        # covariance).
        stage_acc = jnp.mean(accs)
        if axis_name:
            stage_acc = jax.lax.pmean(stage_acc, axis_name)
        lms = state.log_move_scale
        if cfg.adapt_move:
            upd = lms + cfg.move_adapt_rate * (
                stage_acc - cfg.target_move_accept
            )
            lms = jnp.where(done, lms, jnp.clip(upd, -6.0, 3.0))

        lt_new = jax.vmap(log_target)(z_new)
        lq_new = jax.vmap(log_q0)(z_new)
        new = SMCState(
            z=jnp.where(done, state.z, z_new),
            log_target=jnp.where(done, state.log_target, lt_new),
            log_q0=jnp.where(done, state.log_q0, lq_new),
            beta=beta_new,
            log_evidence=state.log_evidence
            + jnp.where(done, 0.0, log_ev_inc),
            log_move_scale=lms,
            key=key,
        )
        return new, (beta_new, jnp.mean(accs), ~done)

    return stage


def run_smc(
    log_target: Callable[[Array], Array],
    sample_q0: Callable[[Array, int], Array],   # (key, n) -> [n, P]
    log_q0: Callable[[Array], Array],
    key: Array,
    cfg: SMCConfig = SMCConfig(),
    axis_name: str | None = None,
):
    """Run adaptive tempered SMC.  Fully traceable; jit (or shard_map +
    jit, with per-shard keys made identical via the caller) yourself.

    Returns (particles [N, P], info dict with log_evidence, n_stages,
    final beta, acceptance)."""
    state, n_total = _smc_init(log_target, sample_q0, log_q0, key, cfg,
                               axis_name)
    d = state.z.shape[-1]
    stage = _make_smc_stage(log_target, log_q0, cfg, axis_name, n_total, d)
    state, (betas, accs, active) = jax.lax.scan(
        stage, state, None, length=cfg.max_stages
    )
    # Masked mean: stages after beta = 1 are no-ops whose acceptance is
    # meaningless.
    act = active.astype(jnp.float32)
    accept = jnp.sum(accs * act) / jnp.maximum(jnp.sum(act), 1.0)
    if axis_name:
        # per-shard move acceptance -> pooled global mean (also required
        # for the replicated out_spec under check_vma)
        accept = jax.lax.pmean(accept, axis_name)
    info = dict(
        log_evidence=state.log_evidence,
        beta=state.beta,
        n_stages=jnp.sum(active.astype(jnp.int32)),
        accept=accept,
        betas=betas,
        move_scale=jnp.exp(state.log_move_scale),
    )
    return state.z, info


def run_smc_replicated(
    log_target: Callable[[Array], Array],
    sample_q0: Callable[[Array, int], Array],
    log_q0: Callable[[Array], Array],
    key: Array,
    cfg: SMCConfig = SMCConfig(),
    n_rep: int = 4,
):
    """R independent SMC runs (vmapped — one compile, R× the work):
    particles pool across replicates, and the log-evidence estimate
    gains an honest repeat-run standard error (VERDICT r3 #6 — a point
    log_evidence with no spread is unfalsifiable).

    Returns (particles [n_rep * N, P], info) where info adds
    `log_evidence_se` (std over replicates / sqrt(n_rep)) and
    `log_evidences` [n_rep]; scalar fields are replicate means.
    Single-device only (replicates would nest vmap over the shard_map
    collectives) — the sharded path quotes per-run evidence.
    """
    keys = jax.random.split(key, n_rep)
    particles, infos = jax.vmap(
        lambda k: run_smc(log_target, sample_q0, log_q0, k, cfg)
    )(keys)
    les = infos["log_evidence"]                      # [n_rep]
    info = dict(
        log_evidence=jnp.mean(les),
        log_evidence_se=jnp.std(les) / jnp.sqrt(float(n_rep)),
        log_evidences=les,
        beta=jnp.min(infos["beta"]),
        n_stages=jnp.max(infos["n_stages"]),
        accept=jnp.mean(infos["accept"]),
        betas=infos["betas"],
        move_scale=jnp.mean(infos["move_scale"]),
    )
    return particles.reshape(-1, particles.shape[-1]), info


def make_smc_chunked_runner(
    log_target: Callable[[Array], Array],
    sample_q0: Callable[[Array, int], Array],
    log_q0: Callable[[Array], Array],
    cfg: SMCConfig = SMCConfig(),
    n_rep: int = 4,
):
    """Host-chunked replicated SMC: ONE device execution per tempering
    stage (all replicates advance together, vmapped), with the host
    loop stopping as soon as every replicate reaches beta = 1.

    This is the production shape for big densities: the single-jit
    run_smc_replicated executes all ~15 stages x n_move moves x
    n_particles density evals in one device program, while here the
    host sees every stage.  Same math as run_smc: the per-stage function is
    the SAME _make_smc_stage closure, and stopping early is exact
    because post-beta=1 stages are no-ops on every state field except
    the (unused) RNG key.

    Returns runner(key) -> (particles [n_rep * N, P], info) with the
    run_smc_replicated info contract (log_evidence +- se, stages,
    pooled acceptance, move_scale).
    """
    def init_fn(key):
        keys = jax.random.split(key, n_rep)
        return jax.vmap(
            lambda k: _smc_init(log_target, sample_q0, log_q0, k, cfg,
                                None)[0]
        )(keys)

    n_total = jnp.asarray(cfg.n_particles, jnp.float32)

    def one_stage(states):
        stage = _make_smc_stage(log_target, log_q0, cfg, None, n_total,
                                states.z.shape[-1])
        return jax.vmap(stage)(states)

    init_jit = jax.jit(init_fn)
    stage_jit = jax.jit(one_stage)

    def runner(key):
        states = init_jit(key)
        jax.block_until_ready(states.z)
        betas, accs, actives = [], [], []
        for _ in range(cfg.max_stages):
            states, (b, a, act) = stage_jit(states)
            jax.block_until_ready(states.z)
            betas.append(np.asarray(b))
            accs.append(np.asarray(a))
            actives.append(np.asarray(act))
            if not actives[-1].any():
                break
        act = np.stack(actives).astype(np.float32)       # [stages, R]
        accs = np.stack(accs)
        per_rep_acc = (accs * act).sum(0) / np.maximum(act.sum(0), 1.0)
        les = np.asarray(states.log_evidence)            # [R]
        info = dict(
            log_evidence=float(les.mean()),
            log_evidence_se=float(les.std() / np.sqrt(n_rep)),
            log_evidences=les,
            beta=float(np.asarray(states.beta).min()),
            n_stages=int(act.sum(0).max()),
            accept=float(per_rep_acc.mean()),
            betas=np.stack(betas),
            move_scale=float(np.exp(np.asarray(
                states.log_move_scale)).mean()),
        )
        z = np.asarray(states.z).reshape(-1, states.z.shape[-1])
        return jnp.asarray(z), info

    return runner
