"""ADVI-style variational inference over the cluster log density.

The reference has no VI; it is required by the north star
(BASELINE.json:5 "NUTS/HMC, VI, and SMC").  Standard ADVI (Kucukelbir et
al. 2017): a Gaussian family in the *unconstrained* space of
utils.transforms (mean-field diagonal or full-rank Cholesky), fitted by
maximizing the reparameterized ELBO with Adam.  The ELBO gradient is
just grad through `logpost_z` — the same jitted density the samplers
use — so VI costs one batched density eval per step and serves as a
fast initializer for HMC/SMC (posterior-shaped init + mass matrix).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax import Array

# Full float32 for the tiny [P, P] products (no TF32 on a GPU).
_HI = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class VIConfig:
    n_steps: int = 1500
    n_mc: int = 16            # MC samples per ELBO gradient
    learning_rate: float = 2e-2
    full_rank: bool = False
    init_log_sd: float = -2.0


class VIResult(NamedTuple):
    mu: Array          # [P]
    scale: Array       # [P] (mean-field sd) or [P, P] (Cholesky factor)
    elbo_trace: Array  # [n_steps]
    final_elbo: Array


def _sample_and_entropy(params, key, n_mc: int, full_rank: bool):
    mu = params["mu"]
    P = mu.shape[0]
    eps = jax.random.normal(key, (n_mc, P))
    if full_rank:
        # scale_tril parameterized by packed lower triangle with
        # softplus-positive diagonal for identifiability.
        tril = params["tril"]
        diag = jax.nn.softplus(jnp.diagonal(tril)) + 1e-6
        L = jnp.tril(tril, -1) + jnp.diag(diag)
        z = mu[None, :] + jnp.matmul(eps, L.T, precision=_HI)
        entropy = jnp.sum(jnp.log(diag)) + 0.5 * P * (
            1.0 + jnp.log(2.0 * jnp.pi)
        )
    else:
        sd = jnp.exp(params["log_sd"])
        z = mu[None, :] + eps * sd[None, :]
        entropy = jnp.sum(params["log_sd"]) + 0.5 * P * (
            1.0 + jnp.log(2.0 * jnp.pi)
        )
    return z, entropy


def run_vi(
    logpost_z: Callable[[Array], Array],
    init_mu: Array,
    key: Array,
    cfg: VIConfig = VIConfig(),
) -> VIResult:
    """Fit the Gaussian family; fully traceable (jit yourself)."""
    P = init_mu.shape[0]
    if cfg.full_rank:
        params = dict(
            mu=init_mu,
            tril=jnp.diag(jnp.full((P,), cfg.init_log_sd)),
        )
    else:
        params = dict(
            mu=init_mu, log_sd=jnp.full((P,), cfg.init_log_sd)
        )

    opt = optax.adam(cfg.learning_rate)
    opt_state = opt.init(params)

    def neg_elbo(params, k):
        z, entropy = _sample_and_entropy(params, k, cfg.n_mc, cfg.full_rank)
        lp = jax.vmap(logpost_z)(z)
        return -(jnp.mean(lp) + entropy)

    def step(carry, k):
        params, opt_state = carry
        loss, g = jax.value_and_grad(neg_elbo)(params, k)
        updates, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), -loss

    keys = jax.random.split(key, cfg.n_steps)
    (params, _), elbos = jax.lax.scan(step, (params, opt_state), keys)

    if cfg.full_rank:
        diag = jax.nn.softplus(jnp.diagonal(params["tril"])) + 1e-6
        L = jnp.tril(params["tril"], -1) + jnp.diag(diag)
        scale = L
    else:
        scale = jnp.exp(params["log_sd"])
    return VIResult(
        mu=params["mu"], scale=scale, elbo_trace=elbos,
        final_elbo=jnp.mean(elbos[-50:]),
    )


def _init_params(init_mu: Array, cfg: VIConfig) -> dict:
    P = init_mu.shape[0]
    if cfg.full_rank:
        return dict(
            mu=init_mu, tril=jnp.diag(jnp.full((P,), cfg.init_log_sd))
        )
    return dict(mu=init_mu, log_sd=jnp.full((P,), cfg.init_log_sd))


def run_vi_chunked(
    logpost_z: Callable[[Array], Array],
    init_mu: Array,
    key: Array,
    cfg: VIConfig = VIConfig(),
    chunk_steps: int = 200,
) -> VIResult:
    """Host-chunked VI: the Adam loop runs as ceil(n_steps/chunk) jitted
    scan executions carrying (params, opt_state) across the host
    boundary — bit-identical to run_vi (same keys consumed in order),
    one device execution per chunk (the same shape as
    driver.make_hmc_chunked_runner)."""
    opt = optax.adam(cfg.learning_rate)
    params = _init_params(init_mu, cfg)
    opt_state = opt.init(params)

    def neg_elbo(params, k):
        z, entropy = _sample_and_entropy(params, k, cfg.n_mc, cfg.full_rank)
        lp = jax.vmap(logpost_z)(z)
        return -(jnp.mean(lp) + entropy)

    def step(carry, k):
        params, opt_state = carry
        loss, g = jax.value_and_grad(neg_elbo)(params, k)
        updates, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), -loss

    chunk_fn = jax.jit(
        lambda carry, ks: jax.lax.scan(step, carry, ks)
    )
    keys = jax.random.split(key, cfg.n_steps)
    elbos = []
    carry = (params, opt_state)
    for lo in range(0, cfg.n_steps, chunk_steps):
        carry, e = chunk_fn(carry, keys[lo : lo + chunk_steps])
        elbos.append(e)
    params, _ = carry
    elbo_trace = jnp.concatenate(elbos)

    if cfg.full_rank:
        diag = jax.nn.softplus(jnp.diagonal(params["tril"])) + 1e-6
        scale = jnp.tril(params["tril"], -1) + jnp.diag(diag)
    else:
        scale = jnp.exp(params["log_sd"])
    return VIResult(
        mu=params["mu"], scale=scale, elbo_trace=elbo_trace,
        final_elbo=jnp.mean(elbo_trace[-50:]),
    )


def posterior_covariance(res: VIResult) -> Array:
    """Sigma of the fitted family — a warm-start HMC metric (inv_mass =
    posterior covariance; see hmc.warmup inv_mass0)."""
    if res.scale.ndim == 2:
        return jnp.matmul(res.scale, res.scale.T, precision=_HI)
    return jnp.diag(res.scale * res.scale)


def vi_warm_start(
    logpost_z: Callable[[Array], Array],
    z0: Array,
    key: Array,
    n_chains: int,
    free_mask=None,
    cfg: VIConfig | None = None,
    chunk_steps: int = 100,
):
    """Full-rank-VI warm start for HMC at scale: returns
    (init_z [C, P], inv_mass0 [P, P], VIResult).

    At pod scale the posterior is far tighter than chain-init jitter and
    an identity-metric warmup never finds it (VERDICT r3 #1); VI lands
    the chains in the typical set and its covariance seeds the dense
    metric (hmc.warmup / driver runner `inv_mass0`).  Pinned dims
    (free_mask 0) keep z0's value in the draws and a unit diagonal in
    the metric — matching hmc._window_update's own projection."""
    if cfg is None:
        cfg = VIConfig(n_steps=600, n_mc=8, full_rank=True,
                       learning_rate=2e-2, init_log_sd=-4.0)
    res = run_vi_chunked(logpost_z, z0, key, cfg, chunk_steps)
    cov = posterior_covariance(res)
    draws = sample_posterior(res, jax.random.fold_in(key, 1), n_chains)
    if free_mask is not None:
        m = jnp.asarray(free_mask, jnp.float32)
        cov = cov * (m[:, None] * m[None, :]) + jnp.diag(1.0 - m)
        draws = jnp.where(m[None, :] > 0, draws, z0[None, :])
    return draws, cov, res


def sample_posterior(res: VIResult, key: Array, n: int) -> Array:
    """Draw n samples from the fitted family (unconstrained space)."""
    P = res.mu.shape[0]
    eps = jax.random.normal(key, (n, P))
    if res.scale.ndim == 2:
        return res.mu[None, :] + jnp.matmul(eps, res.scale.T, precision=_HI)
    return res.mu[None, :] + eps * res.scale[None, :]
