"""Per-star conditional posteriors given cluster-parameter draws.

Rebuild of the post-processing samplers [upstream: sampleMass/
and sampleWDMass/ — SURVEY.md E5, E6, §3.4]: the main sampler
marginalizes per-star masses out; these recover p(mass | theta_t, data)
for each posterior draw theta_t.  The reference runs an MH loop per
(draw, star); here the conditional is sampled EXACTLY with no inner
MCMC:

- MS stars: the marginal likelihood is a sum of closed-form segment
  integrals (model.likelihood) — so the conditional factorizes as
  categorical(segment, q-node) x truncated-Gaussian(position within the
  segment).  One Gumbel draw + one truncated-normal draw per star, all
  vmapped over draws.
- WD stars: categorical over the precursor-mass grid (the likelihood is
  already nodal there), then the deterministic chain gives WD mass and
  cooling age per draw.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from base_tpu import constants as C
from base_tpu.grids.isochrone import derive_isochrone
from base_tpu.model import ifmr as ifmr_mod
from base_tpu.model import likelihood as lk
from base_tpu.model import wd as wd_mod
from base_tpu.model.posterior import SinglePopModel
from base_tpu.ops.special import NEG_INF


class MSMassSamples(NamedTuple):
    mass1: Array       # [D, S] primary ZAMS mass draws
    mass_ratio: Array  # [D, S]
    log_marg: Array    # [D, S] per-star log marginal (diagnostic)
    p_member: Array    # [D, S] posterior P(cluster member | theta, data)


class WDMassSamples(NamedTuple):
    zams_mass: Array   # [D, S]
    wd_mass: Array     # [D, S] via the draw's IFMR
    log_cool_age: Array  # [D, S]
    is_db: Array       # [D, S] sampled atmosphere type
    log_marg: Array    # [D, S]
    p_member: Array    # [D, S] posterior P(cluster member | theta, data)


def membership_posterior(stars, log_marg: Array) -> Array:
    """p(member | theta, data) per star from the already-computed mixture
    terms [BASELINE.json:8 per-star membership]: the density is
    CMprior*L_cluster + (1-CMprior)*L_field, so the membership posterior
    is one sigmoid of the log-odds — no extra likelihood evaluation."""
    log_odds = (stars.log_cm + log_marg) - (
        stars.log_1m_cm + stars.field_logdens
    )
    return jax.nn.sigmoid(log_odds)


def _one_draw_ms(model: SinglePopModel, params: Array, key) -> MSMassSamples:
    age = params[C.Param.AGE]
    y = params[C.Param.YYY]
    feh = params[C.Param.FEH]
    mod = params[C.Param.MOD]
    av = params[C.Param.ABS]
    iso = derive_isochrone(model.grid, feh, y, age)
    table = lk.build_segment_table(
        iso, model.q_grid, mod, av, model.abs_coefs,
        binaries=model.binaries, uniform_q=model.uniform_q,
    )
    stars = model.stars
    # Exact per-(star, segment) pieces, reusing the marginal math.
    d = table.hi - table.lo
    r = stars.obs_mags[:, None, :] - table.lo[None, :, :]
    iv = stars.inv_var[:, None, :]
    alpha = jnp.sum(iv * d[None] * d[None], axis=-1)
    beta = jnp.sum(iv * r * d[None], axis=-1)
    logi = lk.segment_logintegrals(stars, table)            # [S, T]
    logits = jnp.where(
        table.mask[None, :], logi + table.logw[None, :], NEG_INF
    )
    k_seg, k_pos = jax.random.split(key)
    S = logits.shape[0]
    seg = jax.random.categorical(k_seg, logits, axis=-1)     # [S]
    s_idx = jnp.arange(S)
    a = jnp.maximum(alpha[s_idx, seg], lk._ALPHA_EPS)
    mu = beta[s_idx, seg] / a
    sd = 1.0 / jnp.sqrt(a)
    lo_z = (0.0 - mu) / sd
    hi_z = (1.0 - mu) / sd
    t = mu + sd * jax.random.truncated_normal(k_pos, lo_z, hi_z, (S,))
    t = jnp.clip(t, 0.0, 1.0)

    # Map (segment, t) back to primary mass and mass ratio.
    if model.binaries:
        Q = model.q_grid.shape[0]
        e = seg // Q
        qi = seg % Q
        q = model.q_grid[qi]
    else:
        e = seg
        q = jnp.zeros((S,))
    m_lo = iso.mass[e]
    m_hi = iso.mass[e + 1]
    m1 = m_lo + t * (m_hi - m_lo)
    log_marg = lk.ms_star_log_marginals(stars, table)
    return MSMassSamples(
        mass1=m1, mass_ratio=q, log_marg=log_marg,
        p_member=membership_posterior(stars, log_marg),
    )


def _vmap_draws(f, params_draws: Array, keys: Array, chunk: int | None):
    """vmap over the draw axis, optionally in sequential blocks of
    `chunk` draws (lax.map) — each draw materializes [S, T, B]
    intermediates, so a thousand-draw batch over a few hundred stars
    exhausts HBM without chunking (same memory bound as
    HMCConfig.chain_chunk)."""
    D = params_draws.shape[0]
    if chunk is None or chunk >= D:
        return jax.vmap(f)(params_draws, keys)
    # Pad the draw axis up to a chunk multiple (repeating the last draw)
    # and slice the result back to D — a remainder must never disable
    # chunking, or the full [D, S, T] intermediates materialize at once
    # (the HBM blowup the chunking exists to prevent).
    G = -(-D // chunk)
    pad = G * chunk - D
    if pad:
        params_draws = jnp.concatenate(
            [params_draws, jnp.broadcast_to(
                params_draws[-1:], (pad,) + params_draws.shape[1:])]
        )
        keys = jnp.concatenate(
            [keys, jnp.broadcast_to(keys[-1:], (pad,) + keys.shape[1:])]
        )
    pb = params_draws.reshape(G, chunk, -1)
    kb = keys.reshape((G, chunk) + keys.shape[1:])
    out = jax.lax.map(lambda pk: jax.vmap(f)(pk[0], pk[1]), (pb, kb))
    return jax.tree_util.tree_map(
        lambda x: x.reshape((-1,) + x.shape[2:])[:D], out
    )


def sample_ms_masses(
    model: SinglePopModel, params_draws: Array, key,
    draw_chunk: int | None = 64,
) -> MSMassSamples:
    """Exact (mass1, massRatio) conditional draws for every (posterior
    draw, MS star).  params_draws [D, 9] -> fields [D, S]."""
    D = params_draws.shape[0]
    keys = jax.random.split(key, D)
    return _vmap_draws(
        lambda p, k: _one_draw_ms(model, p, k), params_draws, keys,
        draw_chunk,
    )


def _one_draw_wd(model: SinglePopModel, params: Array, key) -> WDMassSamples:
    stars = model.wd_stars
    mz = model.mz_grid
    mod = params[C.Param.MOD]
    av = params[C.Param.ABS]
    age = params[C.Param.AGE]
    mags, _, valid = wd_mod.wd_model_mags(
        model.grid, model.wd_cooling, model.wd_atm, params, mz,
        model.ifmr_kind,
    )
    dist = mod + av * model.abs_coefs
    app = mags + dist[None, None, :]
    diff = stars.obs_mags[None, :, None, :] - app[:, None, :, :]
    chi2 = jnp.sum(diff * diff * stars.inv_var[None, :, None, :], axis=-1)
    ll = -0.5 * chi2 + stars.log_norm[None, :, None]          # [2, S, K]
    dm = jnp.gradient(mz)
    from base_tpu.model import priors

    logw = priors.log_imf(mz) + jnp.log(jnp.maximum(dm, 1e-30))
    wa = jnp.log(jnp.clip(1.0 - model.p_db, 1e-6, 1.0))
    wb = jnp.log(jnp.clip(model.p_db, 1e-6, 1.0))
    type_w = jnp.asarray([wa, wb])[:, None, None]
    logits = jnp.where(
        valid[None, None, :], ll + logw[None, None, :] + type_w, NEG_INF
    )                                                          # [2, S, K]
    S = logits.shape[1]
    K = logits.shape[2]
    flat = jnp.swapaxes(logits, 0, 1).reshape(S, 2 * K)        # [S, 2K]
    idx = jax.random.categorical(key, flat, axis=-1)           # [S]
    is_db = idx >= K
    ki = idx % K
    zams = mz[ki]
    m_wd = ifmr_mod.ifmr_mass(model.ifmr_kind, zams, params)
    prec = wd_mod.wd_prec_logage(
        model.grid, params[C.Param.FEH], params[C.Param.YYY], zams
    )
    delta = jnp.clip(prec - age, -30.0, -1e-4)
    log_cool = age + jnp.log10(1.0 - 10.0 ** delta)
    from base_tpu.ops.special import masked_logsumexp

    log_marg = masked_logsumexp(flat, flat > NEG_INF / 2, axis=-1)
    return WDMassSamples(
        zams_mass=zams, wd_mass=m_wd, log_cool_age=log_cool,
        is_db=is_db, log_marg=log_marg,
        p_member=membership_posterior(stars, log_marg),
    )


def sample_wd_masses(
    model: SinglePopModel, params_draws: Array, key,
    draw_chunk: int | None = 64,
) -> WDMassSamples:
    """Precursor/WD mass + cooling-age conditional draws for every
    (posterior draw, WD star) — the sampleWDMass deliverable
    (BASELINE.json:9).  params_draws [D, 9] -> fields [D, S]."""
    D = params_draws.shape[0]
    keys = jax.random.split(key, D)
    return _vmap_draws(
        lambda p, k: _one_draw_wd(model, p, k), params_draws, keys,
        draw_chunk,
    )
