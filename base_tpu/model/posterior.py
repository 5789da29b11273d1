"""Posterior assembly: the jittable `log_post(params) -> scalar` density.

This is the analog of the reference's logPostStep [upstream:
singlePopMcmc/MpiMcmcApplication.cpp — SURVEY.md §3.1]: bounds check ->
cluster prior -> isochrone derive -> per-star marginal likelihoods ->
field mixture -> total.  It is a pure function of (model pytree, params
vector), so samplers vmap it over chains and grad through it for
HMC/NUTS.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from base_tpu import constants as C
from base_tpu.grids import filters as filt
from base_tpu.grids.isochrone import (
    IsochroneGrid,
    derive_isochrone,
    upsample_isochrone,
)
from base_tpu.model import likelihood as lk
from base_tpu.model.priors import ClusterPriors
from base_tpu.model.stardata import MSStars
from base_tpu.ops.special import NEG_INF
from base_tpu.utils.transforms import IntervalTransform, make_interval_transform


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SinglePopModel:
    """Everything static for one single-population inference run.

    The WD branch is optional: `wd_stars is None` (a static pytree
    structure difference) compiles the MS-only density; with WD fields
    set, log_post adds the precursor-mass-marginalized WD likelihood
    [SURVEY.md C6-C8, BASELINE.json:9]."""

    grid: IsochroneGrid
    stars: MSStars
    priors: ClusterPriors
    q_grid: Array      # [Q] mass-ratio quadrature nodes
    abs_coefs: Array   # [B] A_band / A_V
    wd_cooling: object = None    # WdCoolingGrid | None
    wd_atm: object = None        # WdAtmosphereGrid | None
    wd_stars: object = None      # WDStars (MSStars layout) | None
    mz_grid: object = None       # [K] precursor-mass nodes | None
    binaries: bool = dataclasses.field(metadata=dict(static=True), default=True)
    uniform_q: bool = dataclasses.field(metadata=dict(static=True), default=False)
    ifmr_kind: str = dataclasses.field(metadata=dict(static=True), default="linear")
    p_db: float = dataclasses.field(metadata=dict(static=True), default=0.1)
    # Quadrature refinement: insert (upsample - 1) exact piecewise-linear
    # nodes per EEP segment before marginalizing, so adjacent nodes differ
    # by << sigma_obs in magnitude space (grids.isochrone.upsample_isochrone).
    upsample: int = dataclasses.field(metadata=dict(static=True), default=1)


def make_single_pop_model(
    grid: IsochroneGrid,
    stars: MSStars,
    prior_mean: np.ndarray,
    prior_sigma: np.ndarray,
    n_q: int = 16,
    binaries: bool = True,
    uniform_q: bool = False,
    wd_cooling=None,
    wd_atm=None,
    wd_stars=None,
    n_mz: int = 96,
    ifmr_kind: str = "linear",
    p_db: float = 0.1,
    upsample: int = 1,
) -> SinglePopModel:
    mz_grid = None
    if wd_stars is not None:
        if wd_cooling is None or wd_atm is None:
            raise ValueError("wd_stars requires wd_cooling and wd_atm grids")
        mz_grid = jnp.linspace(
            0.8, C.MAX_WD_PRECURSOR_MASS, n_mz, dtype=jnp.float32
        )
    return SinglePopModel(
        grid=grid,
        stars=stars,
        priors=ClusterPriors(
            mean=jnp.asarray(prior_mean, jnp.float32),
            sigma=jnp.asarray(prior_sigma, jnp.float32),
        ),
        q_grid=jnp.linspace(0.0, 1.0, n_q, dtype=jnp.float32),
        abs_coefs=jnp.asarray(filt.absorption_coefs(grid.bands)),
        wd_cooling=wd_cooling,
        wd_atm=wd_atm,
        wd_stars=wd_stars,
        mz_grid=mz_grid,
        binaries=binaries,
        uniform_q=uniform_q,
        ifmr_kind=ifmr_kind,
        p_db=p_db,
        upsample=upsample,
    )


def segment_table(model: SinglePopModel, params: Array):
    """(segment table, isochrone) of one proposal: the MS stars' mass
    quadrature before the per-star marginal."""
    age = params[C.Param.AGE]
    y = params[C.Param.YYY]
    feh = params[C.Param.FEH]
    mod = params[C.Param.MOD]
    av = params[C.Param.ABS]
    # Named scopes label each layer's device work in profiler traces.
    with jax.named_scope("isochrone"):
        base_iso = derive_isochrone(model.grid, feh, y, age)
        iso = base_iso
        if model.upsample > 1:
            iso = upsample_isochrone(base_iso, model.upsample)
    # Secondary lookup stays on the BASE node set so upsample refines
    # the quadrature without changing the continuous model
    # (likelihood.combined_node_mags docstring).
    with jax.named_scope("segment_table"):
        table = lk.build_segment_table(
            iso,
            model.q_grid,
            mod,
            av,
            model.abs_coefs,
            binaries=model.binaries,
            uniform_q=model.uniform_q,
            sec_iso=base_iso,
        )
    return table, iso


def log_lik(model: SinglePopModel, params: Array) -> tuple[Array, Array]:
    """Total per-star log likelihood and the bounds flag, separated from
    the prior so sharded runners can psum the star-sum across a mesh
    axis before adding the (replicated) prior.  Returns (ll, in_bounds).
    """
    table, iso = segment_table(model, params)
    with jax.named_scope("marginal"):
        ll = lk.ms_total_loglik(model.stars, table)
    if model.wd_stars is not None:
        from base_tpu.model import wd as wd_mod

        with jax.named_scope("wd_branch"):
            mags, _, valid = wd_mod.wd_model_mags(
                model.grid, model.wd_cooling, model.wd_atm, params,
                model.mz_grid, model.ifmr_kind,
            )
            ll = ll + wd_mod.wd_total_loglik(
                model.wd_stars, mags, valid, model.mz_grid,
                params[C.Param.MOD], params[C.Param.ABS],
                model.abs_coefs, model.p_db,
            )
    return ll, iso.in_bounds


def log_post(model: SinglePopModel, params: Array) -> Array:
    """Un-normalized log posterior of the 9-param cluster vector.

    Out-of-hull (age, Y, FeH) returns NEG_INF — the reference's bounds
    shortcut [SURVEY.md §3.1]; gradient samplers avoid the cliff by
    sampling through `default_transform`.
    """
    ll, in_bounds = log_lik(model, params)
    lp = model.priors.log_prior(params)
    return jnp.where(in_bounds, ll + lp, NEG_INF)


def free_mask(model: SinglePopModel) -> tuple:
    """Sampled-parameter mask for HMCConfig/NUTSConfig.free_mask.

    Density-flat dims are pinned (the reference's step-scale-0 pinning,
    SURVEY.md §3.1): carbonicity and the IFMR coefficients only matter
    with a WD branch, and the quadratic coefficient (slot 8) only under
    ifmr_kind == 'quadratic'.  One helper so the HMC/NUTS/MH CLI paths
    cannot drift apart."""
    m = np.zeros(C.NPARAMS, np.float32)
    m[[C.Param.AGE, C.Param.YYY, C.Param.FEH, C.Param.MOD,
       C.Param.ABS]] = 1.0
    if model.wd_stars is not None:
        m[C.Param.CARBONICITY] = 1.0
        if model.ifmr_kind in ("linear", "quadratic"):
            m[C.Param.IFMR_INTERCEPT] = 1.0
            m[C.Param.IFMR_SLOPE] = 1.0
        if model.ifmr_kind == "quadratic":
            m[C.Param.IFMR_QUADCOEF] = 1.0
    return tuple(float(v) for v in m)


def default_transform(model: SinglePopModel, margin: float = 1e-3) -> IntervalTransform:
    """Unconstrained-space bijection with bounds from the grid hull.

    age/Y/FeH: grid extent (slightly shrunk); A_V in [0, 10];
    carbonicity in [0, 1]; modulus and IFMR coefficients unbounded.
    """
    g = model.grid
    lo = np.full(C.NPARAMS, -np.inf, np.float32)
    hi = np.full(C.NPARAMS, np.inf, np.float32)

    def span(ax):
        a0, a1 = float(ax[0]), float(ax[-1])
        d = (a1 - a0) * margin
        return a0 + d, a1 - d

    lo[C.Param.AGE], hi[C.Param.AGE] = span(g.age)
    lo[C.Param.YYY], hi[C.Param.YYY] = span(g.y)
    lo[C.Param.FEH], hi[C.Param.FEH] = span(g.feh)
    lo[C.Param.ABS], hi[C.Param.ABS] = 0.0, 10.0
    lo[C.Param.CARBONICITY], hi[C.Param.CARBONICITY] = 0.0, 1.0
    return make_interval_transform(lo, hi)


def make_logpost_fn(model: SinglePopModel):
    """Returns `f(params) -> scalar` closed over the model pytree."""

    def f(params: Array) -> Array:
        return log_post(model, params)

    return f


def make_logpost_z_fn(model: SinglePopModel, transform: IntervalTransform):
    """Unconstrained-space density for HMC/NUTS: logpost(x(z)) + log|J|."""

    def f(z: Array) -> Array:
        x = transform.forward(z)
        return log_post(model, x) + transform.log_det_jacobian(z)

    return f
