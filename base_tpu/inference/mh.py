"""Adaptive Metropolis-Hastings — the reference-parity sampler.

Rebuild of the reference's 3-stage scheme [upstream: singlePopMcmc/
MpiMcmcApplication.cpp propClustBigSteps/Indep/Correlated + base9/
McmcApplication.cpp acceptClustMarg — SURVEY.md C11, E1, §3.1]:

  stage 1  independent per-parameter Gaussian proposals, step scales
           tuned multiplicatively against the acceptance rate;
  stage 2  fixed independent proposals, samples collected for an
           empirical covariance -> Cholesky factor;
  stage 3  correlated proposals theta' = theta + s L z (s = 2.38/sqrt(d)).

The reference runs ONE chain with CPU threads inside the likelihood; here
the sampler itself is a pure `lax.scan` program `vmap`ped over many
chains on one chip (and sharded across chips by base_tpu.parallel).
Fixed parameters (step scale 0, e.g. IFMR coefficients in an MS-only
run) never move and are excluded from the covariance.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from base_tpu.ops.special import NEG_INF
from base_tpu.utils.vma import vma_like


class MHState(NamedTuple):
    position: Array  # [P]
    logpost: Array   # scalar
    key: Array


@dataclasses.dataclass(frozen=True)
class MHConfig:
    n_stage1: int = 1000
    n_stage2: int = 1000
    n_main: int = 5000
    thin: int = 1
    adapt_every: int = 50
    target_accept: float = 0.25
    stage3_scale: float | None = None  # default 2.38/sqrt(n_free)


def _mh_step(logpost_fn: Callable, state: MHState, delta: Array) -> tuple[MHState, Array]:
    """One Metropolis step with a precomputed proposal offset `delta`."""
    key, k_acc = jax.random.split(state.key)
    prop = state.position + delta
    lp_prop = logpost_fn(prop)
    log_u = jnp.log(jax.random.uniform(k_acc, ()))
    accept = log_u < (lp_prop - state.logpost)
    accept = accept & (lp_prop > NEG_INF / 2)
    new = MHState(
        position=jnp.where(accept, prop, state.position),
        logpost=jnp.where(accept, lp_prop, state.logpost),
        key=key,
    )
    return new, accept


def run_adaptive_mh(
    logpost_fn: Callable,
    init_position: Array,
    key: Array,
    step_init: Array,
    cfg: MHConfig = MHConfig(),
    logpost_burnin_fn: Callable | None = None,
):
    """Full 3-stage adaptive MH for one chain (vmap for many).

    Returns (samples [n_main // thin, P], info dict).  step_init [P]:
    initial per-parameter scales; 0 pins a parameter.

    `logpost_burnin_fn`, when given, is the density used during stages
    1-2 — the reference's useDuringBurnIn star subset [SURVEY.md C3/C14]
    restricts burn-in to well-behaved stars; stage 3 always targets the
    full density (with a fresh evaluation at the hand-off).
    """
    P = init_position.shape[0]
    free = (step_init > 0).astype(jnp.float32)
    n_free = jnp.maximum(jnp.sum(free), 1.0)
    burn_fn = logpost_burnin_fn or logpost_fn
    state = MHState(
        position=init_position,
        logpost=burn_fn(init_position),
        key=key,
    )

    # ---- stage 1: multiplicative step tuning -------------------------------
    def stage1_block(carry, _):
        state, step = carry

        def body(c, _):
            st, acc_n = c
            k_prop, key = jax.random.split(st.key)
            st = st._replace(key=key)
            delta = step * free * jax.random.normal(k_prop, (P,))
            st, acc = _mh_step(burn_fn, st, delta)
            return (st, acc_n + acc), None

        (state, acc_n), _ = jax.lax.scan(
            body, (state, vma_like(jnp.zeros(()), state.logpost)), None,
            length=cfg.adapt_every,
        )
        rate = acc_n / cfg.adapt_every
        # Multiplicative tuning toward the target acceptance rate
        # (reference: repeated scaling during burn-in [SURVEY.md §3.1]).
        step = step * jnp.exp(1.5 * (rate - cfg.target_accept))
        return (state, step), rate

    n_blocks = max(cfg.n_stage1 // cfg.adapt_every, 1)
    (state, step), s1_rates = jax.lax.scan(
        stage1_block, (state, vma_like(step_init, state.logpost)), None,
        length=n_blocks,
    )

    # ---- stage 2: fixed proposals, collect covariance ----------------------
    def stage2_body(st, _):
        k_prop, key = jax.random.split(st.key)
        st = st._replace(key=key)
        delta = step * free * jax.random.normal(k_prop, (P,))
        st, acc = _mh_step(burn_fn, st, delta)
        return st, (st.position, acc)

    state, (s2_pos, s2_acc) = jax.lax.scan(
        stage2_body, state, None, length=cfg.n_stage2
    )
    mean = jnp.mean(s2_pos, axis=0)
    centered = (s2_pos - mean) * free[None, :]
    cov = jnp.matmul(centered.T, centered, precision=jax.lax.Precision.HIGHEST
                     ) / max(cfg.n_stage2 - 1, 1)
    # Regularize: pinned params get a unit diagonal so Cholesky exists,
    # then their proposal contribution is masked out anyway.
    cov = cov + jnp.diag(1.0 - free) + 1e-8 * jnp.eye(P)
    chol = jnp.linalg.cholesky(cov)

    # Hand-off: re-evaluate the chain position under the FULL density.
    state = state._replace(logpost=logpost_fn(state.position))

    scale = cfg.stage3_scale
    if scale is None:
        scale_arr = 2.38 / jnp.sqrt(n_free)
    else:
        scale_arr = jnp.asarray(scale, jnp.float32)

    # ---- stage 3: correlated proposals, record samples ---------------------
    def stage3_body(st, _):
        def inner(c, _):
            st, acc_n = c
            k_prop, key = jax.random.split(st.key)
            st = st._replace(key=key)
            z = jax.random.normal(k_prop, (P,))
            delta = scale_arr * jnp.matmul(
                chol, z, precision=jax.lax.Precision.HIGHEST) * free
            st, acc = _mh_step(logpost_fn, st, delta)
            return (st, acc_n + acc), None

        (st, acc_n), _ = jax.lax.scan(
            inner, (st, vma_like(jnp.zeros(()), st.logpost)), None,
            length=cfg.thin,
        )
        return st, (st.position, st.logpost, acc_n)

    n_rec = cfg.n_main // cfg.thin
    state, (samples, logposts, acc_counts) = jax.lax.scan(
        stage3_body, state, None, length=n_rec
    )
    info = dict(
        accept_rate=jnp.sum(acc_counts) / cfg.n_main,
        stage1_rates=s1_rates,
        stage2_accept=jnp.mean(s2_acc),
        step=step,
        chol=chol,
        logposts=logposts,
        final_state=state,
    )
    return samples, info
