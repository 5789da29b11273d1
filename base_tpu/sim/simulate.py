"""Forward cluster simulation — the simCluster equivalent.

Rebuild of the reference simulator [upstream: simCluster/ —
SURVEY.md E3, §3.3]: draw ZAMS masses from the IMF, assign binaries,
evolve every star through the *same* model grids the sampler uses (one
pure function, vmapped), and emit noiseless photometry.  Stars whose
ZAMS mass exceeds the AGB tip evolve through IFMR -> WD cooling ->
atmosphere (DA or DB per `percent_db`), mirroring the reference's WD
branch.  Unlike the C++ (per-star scalar loop), the whole cluster
evaluates as one batched isochrone/WD-chain lookup.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from base_tpu import constants as C
from base_tpu.grids import filters as filt
from base_tpu.grids.isochrone import IsochroneGrid, derive_isochrone

LN10_04 = 0.9210340371976184


class SimCatalog(NamedTuple):
    mags: Array       # [S, B] noiseless apparent magnitudes
    mass1: Array      # [S] primary ZAMS mass
    mass_ratio: Array # [S] secondary/primary (0 = single)
    is_binary: Array  # [S] bool
    stage: Array      # [S] int32 StarStatus (MSRG or WD)
    is_db: Array      # [S] bool (meaningful only where stage == WD)


def sample_imf_masses(key, n: int, lo: float, hi: float) -> Array:
    """Truncated-lognormal IMF draws: log10 M ~ N(mu, sig) on [lo, hi]."""
    zlo = (jnp.log10(lo) - C.IMF_LOG_MEAN) / C.IMF_LOG_SIGMA
    zhi = (jnp.log10(hi) - C.IMF_LOG_MEAN) / C.IMF_LOG_SIGMA
    z = jax.random.truncated_normal(key, zlo, zhi, (n,))
    return 10.0 ** (C.IMF_LOG_MEAN + C.IMF_LOG_SIGMA * z)


def field_cmd_box(ref_mags: Array, spread: float = 3.0):
    """The per-band uniform-field CMD box: cluster span +/- spread.

    Returns (lo[B], hi[B]).  Fitting code should pass `hi - lo` as
    make_ms_stars(field_mag_range=...) so the likelihood's field density
    is normalized over the SAME box the field stars occupy — a
    mis-normalized field density reweights the membership mixture and
    biases the cluster parameters."""
    lo = jnp.min(ref_mags, axis=0) - spread
    hi = jnp.max(ref_mags, axis=0) + spread
    return lo, hi


def simulate_field_stars(
    key, n: int, ref_mags: Array, spread: float = 3.0
) -> Array:
    """Field-star photometry: uniform draws in a CMD box spanning the
    cluster's magnitude range (+/- spread) per band, mirroring the
    reference's uniform field-CMD density assumption [upstream:
    simCluster field stars + base9/densities field component —
    SURVEY.md E3/C9].  Returns [n, B] apparent magnitudes."""
    lo, hi = field_cmd_box(ref_mags, spread)
    u = jax.random.uniform(key, (n, ref_mags.shape[1]))
    return lo[None, :] + u * (hi - lo)[None, :]


def simulate_cluster(
    grid: IsochroneGrid,
    params: Array,
    n_stars: int,
    key,
    percent_binary: float = 0.3,
    min_mass: float = 0.2,
    wd_cooling=None,
    wd_atm=None,
    ifmr_kind: str = "weidemann",
    percent_db: float = 0.1,
    max_mass: float | None = None,
) -> SimCatalog:
    """Simulate a single-population cluster at truth `params` (9-vector).

    Without WD grids, masses truncate below the AGB tip (MS/RGB only).
    With them, the IMF extends to MAX_WD_PRECURSOR_MASS and heavier
    stars come out as WDs (stage=WD, unresolved companions ignored).
    """
    age = params[C.Param.AGE]
    y = params[C.Param.YYY]
    feh = params[C.Param.FEH]
    mod = params[C.Param.MOD]
    av = params[C.Param.ABS]

    iso = derive_isochrone(grid, feh, y, age)
    k1, k2, k3, k4 = jax.random.split(key, 4)

    hull_max = jnp.max(jnp.where(iso.valid > 0.5, iso.mass, 0.0))
    with_wds = wd_cooling is not None and wd_atm is not None
    if max_mass is None:
        m_hi = (
            float(C.MAX_WD_PRECURSOR_MASS) if with_wds
            else float(hull_max) * 0.999
        )
    else:
        m_hi = max_mass
    m1 = sample_imf_masses(k1, n_stars, min_mass, m_hi)
    is_binary = jax.random.uniform(k2, (n_stars,)) < percent_binary
    q = jnp.where(is_binary, jax.random.uniform(k3, (n_stars,)), 0.0)

    dist = mod + av * jnp.asarray(filt.absorption_coefs(grid.bands))
    # PRIMARY: smooth=False — draw from the piecewise-LINEAR curve the
    # sampler's segment-exact marginal integrates over (SBC
    # self-consistency; see Isochrone.mags_at_mass).
    app1 = iso.mags_at_mass(m1, smooth=False) + dist  # [S, B]
    m2 = q * m1
    # SECONDARY: match the fitted density's companion model exactly —
    # the likelihood table looks secondaries up with SMOOTHSTEP weights
    # and switches their flux on over the soft min-mass RAMP
    # (likelihood.combined_node_mags); drawing companions from the hard
    # linear+step model would make the generative model and the fitted
    # density disagree for binaries (r3 advisor finding).
    from base_tpu.model.likelihood import companion_lit_weight

    app2 = iso.mags_at_mass(m2, smooth=True) + dist
    lit = companion_lit_weight(m2, iso.min_mass)[:, None]
    f = jnp.exp(-LN10_04 * app1) + lit * jnp.exp(-LN10_04 * app2)
    ms_mags = -(1.0 / LN10_04) * jnp.log(f)

    is_wd = m1 > iso.agb_tip
    if not with_wds:
        stage = jnp.full((n_stars,), int(C.StarStatus.MSRG), jnp.int32)
        return SimCatalog(
            mags=ms_mags, mass1=m1, mass_ratio=q, is_binary=is_binary,
            stage=stage, is_db=jnp.zeros((n_stars,), bool),
        )

    from base_tpu.grids.wd_atmosphere import wd_mags as atm_mags
    from base_tpu.grids.wd_cooling import wd_teff_radius
    from base_tpu.model import ifmr as ifmr_mod
    from base_tpu.model import wd as wd_mod

    is_db = (jax.random.uniform(k4, (n_stars,)) < percent_db) & is_wd
    prec = wd_mod.wd_prec_logage(grid, feh, y, m1)
    delta = jnp.clip(prec - age, -30.0, -1e-4)
    log_cool = age + jnp.log10(1.0 - 10.0 ** delta)
    m_wd = ifmr_mod.ifmr_mass(ifmr_kind, m1, params)
    carb = params[C.Param.CARBONICITY]
    lt, lr, _ = jax.vmap(
        lambda m, a: wd_teff_radius(wd_cooling, carb, m, a)
    )(m_wd, log_cool)
    logg = wd_mod.LOG_G_SUN + jnp.log10(jnp.maximum(m_wd, 1e-3)) - 2.0 * lr
    mda, _ = jax.vmap(lambda t, g: atm_mags(wd_atm, t, g, 0))(lt, logg)
    mdb, _ = jax.vmap(lambda t, g: atm_mags(wd_atm, t, g, 1))(lt, logg)
    wd_app = jnp.where(is_db[:, None], mdb, mda) + dist

    mags = jnp.where(is_wd[:, None], wd_app, ms_mags)
    stage = jnp.where(
        is_wd, int(C.StarStatus.WD), int(C.StarStatus.MSRG)
    ).astype(jnp.int32)
    q = jnp.where(is_wd, 0.0, q)
    return SimCatalog(
        mags=mags, mass1=m1, mass_ratio=q,
        is_binary=is_binary & ~is_wd, stage=stage, is_db=is_db,
    )
