"""Marginalized per-star photometric likelihood — the hot path.

Dense, vectorised redesign of the reference inner loop [upstream: base9/marg.cpp
margEvolveWithBinary + base9/densities.cpp logLikelihood — SURVEY.md C10,
§3.2].  The reference loops stars x EEPs x secondary-masses x bands with
CPU threads and sums exp(logPost) node contributions; here the same
integral is computed **segment-exactly** as one dense computation:

1. Per proposal, build a combined-magnitude table over (EEP e, mass-ratio
   q_k) nodes: primary mags from the interpolated isochrone, secondary
   mags by mass lookup at m2 = q_k * m1_e, fluxes summed
   (deriveCombinedMags analog), distance modulus + per-band extinction
   applied.  Adjacent EEP nodes bound T = (E-1)*Q mass *segments*.
2. Within a segment the model magnitudes are (by the interpolation model)
   linear in mass, so chi2(t) = alpha t^2 - 2 beta t + gamma is quadratic
   in the segment coordinate t in [0, 1] and the mass integral of
   exp(-chi2/2) is a closed-form Gaussian segment integral (erf
   difference).  The node-sum quadrature of the reference aliases badly
   when EEP spacing in magnitude exceeds sigma_obs; the segment form is
   EXACT for single stars on the piecewise-linear model, at the same
   O(S*T*B) cost (alpha, beta, gamma are three band contractions).
3. Mass marginalization = masked logsumexp over segments with
   IMF x dM x dm2 quadrature weights — log-space, no underflow for faint
   stars.
4. Field-star mixture: logaddexp of the cluster marginal against the
   uniform-CMD field density weighted by the membership prior.

Everything is jittable, vmap-able over chains, and differentiable.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from base_tpu import platform
from base_tpu.grids.isochrone import Isochrone
from base_tpu.model import priors
from base_tpu.model.stardata import MSStars
from base_tpu.ops.special import (
    NEG_INF,
    masked_logsumexp,
    phi_interval_scaled,
)

LN10_04 = 0.9210340371976184  # 0.4 * ln 10
LOG_2PI = 1.8378770664093453
_ALPHA_EPS = 1e-12
_FLAT_EPS = 3e-7   # erf-cancellation guard (see ms_star_log_marginals)


class SegmentTable(NamedTuple):
    """Flattened (EEP-segment x q) model table for one proposal.

    T = (E-1) * Q segments; within each, apparent combined magnitudes run
    linearly from `lo` to `hi` as primary mass runs across the segment.
    """

    lo: Array    # [T, B] apparent combined mags at the segment start
    hi: Array    # [T, B] apparent combined mags at the segment end
    logw: Array  # [T] log prior-mass weights (IMF x dM x dm2)
    mask: Array  # [T] bool


def companion_lit_weight(m2: Array, min_mass: Array) -> Array:
    """Dark-companion cutoff as a RAMP over a small mass width, not a
    step: a hard (m2 >= min_mass) indicator makes the density
    discontinuous in the cluster parameters (every (e, q) node crossing
    min_mass as the isochrone shifts jumps the combined flux by the
    faintest node's flux), and those jumps cap the HMC step size far
    below the posterior scale.  The ramp is the same piecewise-linear
    smoothness class as the interpolation model itself.

    Shared by the likelihood table (combined_node_mags) and the
    simulator (sim.simulate), so the generative model and the fitted
    density agree on how companion flux switches on."""
    w = 0.05 * min_mass + 1e-6
    return jnp.clip((m2 - (min_mass - w)) / w, 0.0, 1.0)


def combined_node_mags(
    iso: Isochrone,
    q_grid: Array,
    modulus: Array,
    absorption: Array,
    abs_coefs: Array,
    sec_iso: Isochrone | None = None,
) -> Array:
    """Apparent combined (primary+secondary) magnitudes at every
    (EEP node, mass ratio) pair: [E, Q, B].

    deriveCombinedMags analog [upstream: base9/StellarSystem.cpp —
    SURVEY.md C3]: mag -> flux, sum, -> mag; companions below the
    isochrone's lowest valid mass are dark (q = 0 lands here).

    `sec_iso` is the isochrone the SECONDARY mass lookup runs against —
    pass the un-upsampled base isochrone when `iso` is quadrature-
    upsampled.  The model's companion magnitude curve is defined as the
    smoothstep lookup on the BASE node set; running it on the fine nodes
    instead would change the continuous model with the quadrature
    resolution (smoothstep over h/u-wide segments converges to the
    piecewise-LINEAR base curve as u grows), so upsampling would chase a
    moving target instead of shrinking the h^2 quadrature bias.
    """
    if sec_iso is None:
        sec_iso = iso
    E = iso.mass.shape[0]
    Q = q_grid.shape[0]
    dist = modulus + absorption * abs_coefs  # [B]
    app1 = iso.mags + dist  # [E, B]
    f1 = jnp.exp(-LN10_04 * app1)
    m2 = iso.mass[:, None] * q_grid[None, :]  # [E, Q]
    mags2 = sec_iso.mags_at_mass(m2.reshape(-1))  # [E*Q, B]
    app2 = mags2.reshape(E, Q, -1) + dist
    # Companions below the isochrone's lowest valid mass are dark (soft
    # ramp — see companion_lit_weight).
    lit = companion_lit_weight(m2, sec_iso.min_mass)  # [E, Q]
    f2 = jnp.exp(-LN10_04 * app2) * lit[..., None]
    return -(1.0 / LN10_04) * jnp.log(f1[:, None, :] + f2)  # [E, Q, B]


def build_segment_table(
    iso: Isochrone,
    q_grid: Array,
    modulus: Array,
    absorption: Array,
    abs_coefs: Array,
    binaries: bool = True,
    uniform_q: bool = False,
    sec_iso: Isochrone | None = None,
) -> SegmentTable:
    """Build the per-proposal segment table.

    q_grid [Q] mass ratios in [0, 1]; q=0 is the no-companion node, which
    the uniform-in-secondary-mass prior covers continuously (the reference
    integrates secondary mass on the EEP grid below the primary
    [SURVEY.md C10]; a fixed q grid is an equivalent static-shape
    quadrature).  `uniform_q` switches the secondary prior from uniform in
    m2 (reference behavior, weight m1*dq) to uniform in q (weight dq).
    `sec_iso`: base isochrone for the secondary lookup when `iso` is
    quadrature-upsampled (see combined_node_mags).
    """
    if binaries:
        comb = combined_node_mags(
            iso, q_grid, modulus, absorption, abs_coefs, sec_iso=sec_iso
        )
        lo = comb[:-1]  # [E-1, Q, B]
        hi = comb[1:]
        logw, mask = _segment_weights(iso, q_grid, uniform_q)
        B = lo.shape[-1]
        return SegmentTable(
            lo=lo.reshape(-1, B),
            hi=hi.reshape(-1, B),
            logw=logw,
            mask=mask,
        )
    else:
        m1 = iso.mass  # [E]
        dm = m1[1:] - m1[:-1]
        m_mid = 0.5 * (m1[1:] + m1[:-1])
        seg_valid = (iso.valid[1:] > 0.5) & (iso.valid[:-1] > 0.5)
        logw_m = priors.log_imf(m_mid) + jnp.log(jnp.maximum(dm, 1e-30))
        dist = modulus + absorption * abs_coefs
        app = iso.mags + dist  # [E, B]
        return SegmentTable(
            lo=app[:-1], hi=app[1:], logw=logw_m, mask=seg_valid
        )


def _segment_weights(iso: Isochrone, q_grid: Array, uniform_q: bool):
    """(logw [T], mask [T]) for the binaries segment table."""
    m1 = iso.mass
    dm = m1[1:] - m1[:-1]                      # [E-1]
    m_mid = 0.5 * (m1[1:] + m1[:-1])
    seg_valid = (iso.valid[1:] > 0.5) & (iso.valid[:-1] > 0.5)
    logw_m = priors.log_imf(m_mid) + jnp.log(jnp.maximum(dm, 1e-30))
    Q = q_grid.shape[0]
    dq = jnp.gradient(q_grid)
    if uniform_q:
        logw_q = jnp.broadcast_to(jnp.log(dq)[None, :], (m_mid.shape[0], Q))
    else:
        # uniform in m2: dm2 = m1 dq
        logw_q = (
            jnp.log(jnp.maximum(m_mid, 1e-12))[:, None]
            + jnp.log(dq)[None, :]
        )
    logw = logw_m[:, None] + logw_q                     # [E-1, Q]
    mask = jnp.broadcast_to(seg_valid[:, None], logw.shape)
    return logw.reshape(-1), mask.reshape(-1)


def _log_ndtr_diff(a: Array, b: Array) -> Array:
    """log(Phi(b) - Phi(a)) for b >= a, stable in both tails.

    Reflects to the left tail (where log_ndtr is computed as an asymptotic
    series) whenever the interval sits in the right tail.
    """
    flip = (a + b) > 0
    aa = jnp.where(flip, -b, a)
    bb = jnp.where(flip, -a, b)
    la = jax.scipy.special.log_ndtr(aa)
    lb = jax.scipy.special.log_ndtr(bb)
    # la <= lb; clamp the ratio away from 1 so log1p stays finite for
    # infinitesimally thin intervals (their weight is negligible anyway).
    d = jnp.minimum(la - lb, -1e-7)
    return lb + jnp.log1p(-jnp.exp(d))


def segment_logintegrals(stars: MSStars, table: SegmentTable) -> Array:
    """log of the exact per-segment Gaussian mass integral, per star: [S, T].

    For segment t with mags m(t) = lo + t (hi - lo), t in [0, 1]:
      chi2(t) = alpha t^2 - 2 beta t + gamma      (per star)
      integral_0^1 exp(-chi2/2) dt
        = exp(-(gamma - beta^2/alpha)/2) sqrt(2 pi / alpha)
          * [Phi(sqrt(alpha)(1 - mu)) - Phi(-sqrt(alpha) mu)],  mu = beta/alpha.
    Computed in residual form (r = obs - lo is O(sigma) near the peak), so
    float32 is exact where it matters.  alpha -> 0 (flat segment) falls
    back to exp(-gamma/2).
    """
    d = table.hi - table.lo                                 # [T, B]
    r = stars.obs_mags[:, None, :] - table.lo[None, :, :]   # [S, T, B]
    iv = stars.inv_var[:, None, :]                          # [S, 1, B]
    alpha = jnp.sum(iv * d[None] * d[None], axis=-1)        # [S, T]
    beta = jnp.sum(iv * r * d[None], axis=-1)
    gamma = jnp.sum(iv * r * r, axis=-1)

    ac = jnp.maximum(alpha, _ALPHA_EPS)
    mu = beta / ac
    resid = jnp.maximum(gamma - beta * beta / ac, 0.0)
    sq = jnp.sqrt(ac)
    log_phi = _log_ndtr_diff(-sq * mu, sq * (1.0 - mu))
    log_i = -0.5 * resid + 0.5 * (LOG_2PI - jnp.log(ac)) + log_phi
    # Near-flat segments: midpoint value (same erf-cancellation guard and
    # threshold as ms_star_log_marginals).
    flat = -0.5 * (gamma - beta + 0.25 * alpha)
    out = jnp.where(alpha > _FLAT_EPS, log_i, flat)
    return out + stars.log_norm[:, None]


SQRT_2PI = 2.5066282746310002
INV_SQRT2 = 0.7071067811865476


def ms_star_log_marginals(stars: MSStars, table: SegmentTable) -> Array:
    """Per-star log marginal cluster likelihood over the segment
    quadrature.  [S]

    Linear-space formulation: the naive path (segment_logintegrals +
    logsumexp) spends ~12 transcendentals per (star, segment) keeping
    every quantity in log space; here the exponentials never leave
    linear space — terms are accumulated as

        exp(-resid/2 + logw - m) * sqrt(2pi/alpha)
          * (erf(u1/sqrt2) - erf(u0/sqrt2))/2

    with the max-shift m taken on the cheap upper bound (-resid/2 +
    logw, since the Phi-difference factor is <= 1 and the sqrt factor is
    within a few nats).  Far-tail terms underflow to exactly 0.0, which
    a sum (unlike a logsumexp) absorbs for free.  Transcendentals per
    element: 1 exp + 2 erf + 1 rsqrt — ~3x fewer; one log per star.
    This is the hot path's hot path (SURVEY.md §3.2).
    """
    d = table.hi - table.lo                                 # [T, B]
    r = stars.obs_mags[:, None, :] - table.lo[None, :, :]   # [S, T, B]
    iv = stars.inv_var[:, None, :]
    alpha = jnp.sum(iv * d[None] * d[None], axis=-1)        # [S, T]
    beta = jnp.sum(iv * r * d[None], axis=-1)
    gamma = jnp.sum(iv * r * r, axis=-1)

    ac = jnp.maximum(alpha, _ALPHA_EPS)
    rsq = jax.lax.rsqrt(ac)
    inv_a = rsq * rsq
    mu = beta * inv_a
    resid = jnp.maximum(gamma - beta * mu, 0.0)
    sq = ac * rsq
    u0 = -mu * sq
    u1 = sq - mu * sq
    # Scaled Phi-difference: width is O(1), and core carries the TRUE
    # on-segment chi2 minimum (resid + u_near^2 — chi2 at the nearest
    # endpoint when the peak lies outside the segment), so the max-shift
    # bound is tight even for tail-dominated stars.
    width_s, unear_sq = phi_interval_scaled(u0, u1)
    # Near-flat segments (u-extent sqrt(alpha) < ~5e-4): the erf
    # difference cancels catastrophically in float32, so switch to the
    # midpoint value exp(-chi2(1/2)/2) — with alpha this small chi2
    # varies by <~1 across the segment, so the midpoint error is tiny
    # exactly where the cancellation error would be huge.
    live = alpha > _FLAT_EPS
    mid = gamma - beta + 0.25 * alpha
    core = jnp.where(
        live, -0.5 * (resid + unear_sq), -0.5 * mid
    ) + table.logw[None, :]
    neg = jnp.asarray(NEG_INF, core.dtype)
    core = jnp.where(table.mask[None, :], core, neg)
    m = jnp.maximum(jnp.max(core, axis=-1, keepdims=True), neg)  # [S, 1]

    width = jnp.where(live, SQRT_2PI * rsq * width_s, 1.0)
    terms = jnp.exp(core - m) * width                        # [S, T]
    terms = jnp.where(table.mask[None, :], terms, 0.0)
    s = jnp.sum(terms, axis=-1)
    # Additive floor, and not a tiny one: 1/s enters the cotangent chain,
    # and a 1e-38 floor makes ~1e38 cotangents that overflow against the
    # rsqrt/erf factors (inf * 0 = NaN).  1e-15 caps the cotangents with
    # ~1e5 of headroom while adding only -34.5 nats — far below the
    # field-mixture floor that dominates such stars anyway.
    out = jnp.squeeze(m, -1) + jnp.log(s + 1e-15)
    out = jnp.where(s > 0, out, neg)
    return out + stars.log_norm


def ms_star_log_marginals_logspace(
    stars: MSStars, table: SegmentTable
) -> Array:
    """Reference log-space path (segment_logintegrals + logsumexp); kept
    for cross-checks and as the numerically-paranoid fallback.  [S]"""
    ll = segment_logintegrals(stars, table)  # [S, T]
    return masked_logsumexp(ll + table.logw[None, :], table.mask[None, :], axis=-1)


def field_mixture_total(stars: MSStars, log_clust: Array) -> Array:
    """Field-star mixture + sum over stars, given per-star cluster
    marginals.

    density_s = CMprior_s * L_cluster_s + (1 - CMprior_s) * L_field_s
    [upstream: field-star mixture in base9/densities.cpp — SURVEY.md C9].
    """
    a = stars.log_cm + log_clust
    b = stars.log_1m_cm + stars.field_logdens
    m = jnp.maximum(a, b)
    per_star = m + jnp.log(jnp.exp(a - m) + jnp.exp(b - m))
    per_star = jnp.maximum(per_star, NEG_INF)
    return jnp.sum(per_star * stars.star_mask)


def mass_prior_log_norm(table: SegmentTable) -> Array:
    """log Z(theta) = log of the total IMF x dM (x dm2) weight over the
    valid segments — the normalizer of the per-star mass prior.

    The reference leaves its mass integral unnormalized [upstream:
    base9/marg.cpp], but Z varies with theta (the integration hull —
    AGB tip, lowest EEP — moves with age/FeH/Y), so the unnormalized
    marginal carries a spurious Z(theta)^S factor that measurably
    biases the posterior low in modulus/FeH: SBC rank histograms pile
    one-sided for any sampler that actually converges (the skew was
    invisible to short under-mixed MH runs and surfaced when HMC
    started mixing).  Normalizing makes p(obs | theta) a proper
    density, which the field mixture also needs.
    """
    return masked_logsumexp(table.logw, table.mask, axis=-1)


def _fused_log_marginals(stars: MSStars, table: SegmentTable) -> Array:
    from base_tpu.ops.pallas_marglik import fused_log_marginals

    return fused_log_marginals(
        stars.obs_mags, stars.inv_var, stars.log_norm,
        table.lo, table.hi, table.logw, table.mask.astype(jnp.float32),
    )


def ms_log_marginals(stars: MSStars, table: SegmentTable) -> Array:
    """Per-star log marginal cluster likelihood [S].  Compiled for a GPU
    it runs the fused kernel (ops.pallas_marglik), elsewhere the jnp
    path; both are parity-tested against each other.  Shared by the
    single-pop, multiPop and WD densities."""
    return platform.by_platform(
        stars, table, gpu=_fused_log_marginals, default=ms_star_log_marginals
    )


def ms_total_loglik(stars: MSStars, table: SegmentTable) -> Array:
    """Total MS-star log likelihood (marginal + field mixture)."""
    log_clust = ms_log_marginals(stars, table)
    log_clust = log_clust - mass_prior_log_norm(table)
    return field_mixture_total(stars, log_clust)


# --- Nodal (pointwise) likelihood helpers -----------------------------------
# Used by the per-star conditional samplers (sampleMass analog) and tests;
# the marginal path above never calls these.


def gaussian_loglik_matrix(stars: MSStars, model_mags: Array) -> Array:
    """log N(obs | model) summed over bands, for all (star, model point).

    Residual form: chi2[s,t] = sum_b (o[s,b] - m[t,b])^2 * w[s,b].  The
    residuals are O(sigma), so float32 is exact where it matters — the
    expanded-quadratic matmul form (see gaussian_loglik_matmul) loses
    ~0.03 in chi2 to cancellation at o^2/sigma^2 ~ 1e6.  With B ~ 8 a
    matrix product would be tiny anyway; XLA fuses the band reduction
    without materializing [S, T, B].
    """
    diff = stars.obs_mags[:, None, :] - model_mags[None, :, :]  # [S,T,B]
    chi2 = jnp.sum(diff * diff * stars.inv_var[:, None, :], axis=-1)
    return -0.5 * chi2 + stars.log_norm[:, None]


def gaussian_loglik_matmul(stars: MSStars, model_mags: Array, center: Array) -> Array:
    """Matrix-product variant for wide band sets (B >~ 64): two
    [S,B]x[B,T] products on per-band-centered magnitudes, in full float32
    (a TF32 product would lose the chi2 to cancellation).  `center` [B] should be ~the mean
    observed magnitude per band to limit float32 cancellation.
    """
    m = model_mags - center[None, :]
    o = stars.obs_mags - center[None, :]
    o = jnp.where(stars.inv_var > 0, o, 0.0)
    hi = jax.lax.Precision.HIGHEST
    cross = jnp.dot(o * stars.inv_var, m.T, precision=hi)
    quad = jnp.dot(stars.inv_var, (m * m).T, precision=hi)
    c0 = jnp.sum(o * o * stars.inv_var, axis=-1)
    chi2 = c0[:, None] - 2.0 * cross + quad
    return -0.5 * chi2 + stars.log_norm[:, None]
