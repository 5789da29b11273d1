"""White-dwarf branch of the likelihood: precursor-mass marginalization
through IFMR -> cooling -> atmosphere.

Rebuild of the reference WD path [upstream: WD branch of
logPostStep in singlePopMcmc/MpiMcmcApplication.cpp + base9/Star.cpp
wdPrecLogAge/coolingAge chain — SURVEY.md C6-C8, §3.1]: for each WD the
per-star likelihood integrates over the unknown ZAMS (precursor) mass on
a fixed grid, chaining

  zams mass -> MS lifetime (precursor log age, from the isochrone grid's
  AGB-tip inversion) -> cooling age = cluster age - lifetime -> WD mass
  (IFMR, possibly with sampled coefficients) -> (Teff, radius) from the
  cooling grid -> log g -> DA/DB atmosphere mags -> Gaussian band loglik.

The whole chain is a static [K]-node computation vmapped over nothing —
all stars share the node set, so the band likelihood is one [S, K, B]
broadcast-reduce like the MS path.  The DA/DB discrete type is
marginalized as a smooth mixture (gradient-safe, SURVEY.md §7 hard-part
#3).  WD stars reuse the MSStars container (same per-star fields).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array, vmap

from base_tpu import constants as C
from base_tpu.grids.isochrone import IsochroneGrid
from base_tpu.grids.wd_atmosphere import WdAtmosphereGrid, wd_mags
from base_tpu.grids.wd_cooling import WdCoolingGrid, wd_teff_radius
from base_tpu.model import ifmr as ifmr_mod
from base_tpu.model import priors
from base_tpu.model.stardata import MSStars
from base_tpu.ops import interp as iops
from base_tpu.ops.special import NEG_INF, masked_logsumexp

WDStars = MSStars  # same per-star observation layout

# log10(g_sun) for M in Msun, R in Rsun: g = G M / R^2 [cgs]
LOG_G_SUN = 4.4383


def wd_prec_logage(grid: IsochroneGrid, feh, y, zams_mass: Array) -> Array:
    """Precursor MS+RGB lifetime log10(age/yr) of a `zams_mass` star.

    Analog of the reference `wdPrecLogAge(feh, zamsMass)` [SURVEY.md C5]:
    inverts the AGB-tip-mass-vs-age curve of the isochrone grid at the
    cluster's (FeH, Y).  tip(age) is monotone decreasing, so the inverse
    is a 1-D interpolation on the negated curve; queries outside the
    grid's age span clamp to its ends.
    """
    corners, weights, _ = iops.gather_corners((grid.feh, grid.y), (feh, y))
    tip = None  # [A] AGB-tip mass vs age at (feh, y)
    for idx, w in zip(corners, weights):
        t = grid.agb_tip[idx] * w
        tip = t if tip is None else tip + t
    # Negate for a monotone-increasing interpolation axis.
    return iops.interp1d(-tip, grid.age[:, None], -zams_mass)[..., 0]


def wd_model_mags(
    iso_grid: IsochroneGrid,
    cooling: WdCoolingGrid,
    atm: WdAtmosphereGrid,
    params: Array,
    mz_grid: Array,          # [K] precursor ZAMS mass nodes
    ifmr_kind: str,
):
    """Absolute DA/DB magnitudes + validity of each precursor-mass node.

    Returns (mags [2, K, B], logg [K], valid [K]).
    """
    age = params[C.Param.AGE]
    feh = params[C.Param.FEH]
    y = params[C.Param.YYY]
    carb = params[C.Param.CARBONICITY]

    prec = wd_prec_logage(iso_grid, feh, y, mz_grid)           # [K]
    # cooling age: 10^age - 10^prec, in log10, stable form.
    delta = jnp.clip(prec - age, -30.0, -1e-4)
    log_cool = age + jnp.log10(1.0 - 10.0 ** delta)
    has_cooled = prec < age - 1e-4

    m_wd = ifmr_mod.ifmr_mass(ifmr_kind, mz_grid, params)      # [K]
    lt, lr, in_cool = vmap(
        lambda m, a: wd_teff_radius(cooling, carb, m, a)
    )(m_wd, log_cool)
    logg = LOG_G_SUN + jnp.log10(jnp.maximum(m_wd, 1e-3)) - 2.0 * lr

    mags_da, in_a = vmap(lambda t, g: wd_mags(atm, t, g, 0))(lt, logg)
    mags_db, in_b = vmap(lambda t, g: wd_mags(atm, t, g, 1))(lt, logg)
    mags = jnp.stack([mags_da, mags_db], axis=0)               # [2, K, B]
    valid = (
        has_cooled
        & in_cool
        & in_a
        & in_b
        & (m_wd > 0.05)
        & (mz_grid < C.MAX_WD_PRECURSOR_MASS)
    )
    return mags, logg, valid


def wd_segment_table(
    mags: Array,        # [2, K, B] absolute model mags (DA, DB)
    valid: Array,       # [K]
    mz_grid: Array,     # [K]
    modulus: Array,
    absorption: Array,
    abs_coefs: Array,
    p_db: float = 0.1,
):
    """Segment table over the precursor-mass chain, DA and DB branches
    concatenated with the mixture weights folded into logw.

    Same construction as the MS path (likelihood.build_segment_table):
    within a segment the apparent magnitudes run linearly from node k to
    node k+1, so the precursor-mass integral is the closed-form Gaussian
    segment integral instead of a node sum.  The nodal sum ALIASES: a
    WD's likelihood width in precursor mass (sigma_phot / |dmag/dMz|,
    ~0.003-0.03 Msun) is far below any affordable node spacing
    (96 nodes -> 0.075 Msun), so as theta moves each WD's peak slides
    between nodes and the summed loglik wiggles by nats — at 400+ stars
    those wells trap HMC chains (r4 config-3 diagnosis: accept 0.9,
    R-hat 3).  The mixture normalizer uses the same segment weights, and
    the shared DA/DB validity mask makes one normalizer serve both
    branches."""
    from base_tpu.model import likelihood as lk

    dist = modulus + absorption * abs_coefs
    app = mags + dist[None, None, :]                           # [2, K, B]
    lo = app[:, :-1, :]
    hi = app[:, 1:, :]
    m_mid = 0.5 * (mz_grid[1:] + mz_grid[:-1])
    dm = mz_grid[1:] - mz_grid[:-1]
    logw_m = priors.log_imf(m_mid) + jnp.log(jnp.maximum(dm, 1e-30))
    seg_valid = (valid[1:] > 0) & (valid[:-1] > 0)
    log_z = masked_logsumexp(logw_m, seg_valid, axis=-1)
    wa = jnp.log(jnp.clip(1.0 - p_db, 1e-6, 1.0))
    wb = jnp.log(jnp.clip(p_db, 1e-6, 1.0))
    B = mags.shape[-1]
    return lk.SegmentTable(
        lo=lo.reshape(-1, B),
        hi=hi.reshape(-1, B),
        logw=jnp.concatenate(
            [logw_m + wa - log_z, logw_m + wb - log_z]),
        mask=jnp.concatenate([seg_valid, seg_valid]),
    )


def wd_star_log_marginals(
    stars: WDStars,
    mags: Array,        # [2, K, B] absolute model mags (DA, DB)
    valid: Array,       # [K]
    mz_grid: Array,     # [K]
    modulus: Array,
    absorption: Array,
    abs_coefs: Array,
    p_db: float = 0.1,
) -> Array:
    """Per-WD log marginal cluster likelihood: segment-exact
    precursor-mass integral, DA/DB mixture.  [S]

    Routes through the same machinery as the MS marginal (the fused
    kernel on a GPU) via a concatenated DA+DB segment table."""
    from base_tpu.model import likelihood as lk

    table = wd_segment_table(
        mags, valid, mz_grid, modulus, absorption, abs_coefs, p_db
    )
    out = lk.ms_log_marginals(stars, table)
    return jnp.maximum(out, NEG_INF)


def wd_star_log_marginals_nodal(
    stars: WDStars,
    mags: Array,        # [2, K, B]
    valid: Array,       # [K]
    mz_grid: Array,     # [K]
    modulus: Array,
    absorption: Array,
    abs_coefs: Array,
    p_db: float = 0.1,
) -> Array:
    """Reference nodal quadrature (the r1-r3 implementation, and the
    reference's own scheme [upstream: WD grid sum in logPostStep]).
    Kept for cross-checks: converges to the segment form as K grows."""
    dist = modulus + absorption * abs_coefs
    app = mags + dist[None, None, :]                           # [2, K, B]
    diff = stars.obs_mags[None, :, None, :] - app[:, None, :, :]  # [2,S,K,B]
    chi2 = jnp.sum(diff * diff * stars.inv_var[None, :, None, :], axis=-1)
    ll = -0.5 * chi2 + stars.log_norm[None, :, None]           # [2, S, K]

    dm = jnp.gradient(mz_grid)
    logw = priors.log_imf(mz_grid) + jnp.log(jnp.maximum(dm, 1e-30))  # [K]
    mask = valid[None, None, :]
    marg = masked_logsumexp(ll + logw[None, None, :], mask, axis=-1)  # [2, S]
    marg = marg - masked_logsumexp(logw, valid, axis=-1)
    lda, ldb = marg[0], marg[1]
    wa = jnp.log(jnp.clip(1.0 - p_db, 1e-6, 1.0))
    wb = jnp.log(jnp.clip(p_db, 1e-6, 1.0))
    a = wa + lda
    b = wb + ldb
    m = jnp.maximum(a, b)
    out = m + jnp.log(jnp.exp(a - m) + jnp.exp(b - m))
    return jnp.maximum(out, NEG_INF)


def wd_total_loglik(
    stars: WDStars,
    mags: Array,
    valid: Array,
    mz_grid: Array,
    modulus: Array,
    absorption: Array,
    abs_coefs: Array,
    p_db: float = 0.1,
) -> Array:
    """Field-mixture total over WD stars (same mixture as the MS path)."""
    log_clust = wd_star_log_marginals(
        stars, mags, valid, mz_grid, modulus, absorption, abs_coefs,
        p_db,
    )
    a = stars.log_cm + log_clust
    b = stars.log_1m_cm + stars.field_logdens
    m = jnp.maximum(a, b)
    per_star = m + jnp.log(jnp.exp(a - m) + jnp.exp(b - m))
    per_star = jnp.maximum(per_star, NEG_INF)
    return jnp.sum(per_star * stars.star_mask)
