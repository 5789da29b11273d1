"""Two-population (helium-spread) cluster model — the multiPopMcmc
equivalent.

Rebuild of the reference multi-pop sampler's density
[upstream: multiPopMcmc/MpiMcmcApplication.cpp, extended param enum
YYA/YYB/LAMBDA — SURVEY.md E2, §3.5; Stenning et al. 2016, NGC 2808-style
per BASELINE.json:10]: the parameter vector grows to 12 (the 9 shared
slots — Y slot unused — plus Y_A, Y_B, lambda), `logPostStep` derives
TWO isochrones per proposal, and each star's marginal likelihood is the
lambda-weighted mixture of its per-population marginals, computed before
the field-star mixing.

The population indicator is marginalized (not Gibbs-sampled as the
reference may do) so the density stays differentiable end to end —
SURVEY.md §7 hard-part #3.  Identifiability: Y_A < Y_B is enforced by
the sampling transform, not the density.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from base_tpu import constants as C
from base_tpu.grids import filters as filt
from base_tpu.grids.isochrone import IsochroneGrid, derive_isochrone
from base_tpu.model import likelihood as lk
from base_tpu.model.priors import ClusterPriors
from base_tpu.model.stardata import MSStars
from base_tpu.ops.special import NEG_INF
from base_tpu.utils.transforms import (
    IntervalTransform,
    jax_sigmoid,
    make_interval_transform,
)

NPARAMS_MP = 12
MP_YYA = 9
MP_YYB = 10
MP_LAMBDA = 11

MP_PARAM_NAMES = C.PARAM_NAMES + ("Y_A", "Y_B", "lambda")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MultiPopModel:
    """Two-population model state.  The WD branch is optional exactly as
    in SinglePopModel: WD stars evaluate against BOTH populations'
    precursor chains and mix with the same lambda [SURVEY.md E2 WD path
    in multiPop logPostStep]."""

    grid: IsochroneGrid
    stars: MSStars
    priors: ClusterPriors    # over the 12-vector
    q_grid: Array
    abs_coefs: Array
    wd_cooling: object = None    # WdCoolingGrid | None
    wd_atm: object = None        # WdAtmosphereGrid | None
    wd_stars: object = None      # WDStars (MSStars layout) | None
    mz_grid: object = None       # [K] precursor-mass nodes | None
    binaries: bool = dataclasses.field(metadata=dict(static=True), default=True)
    uniform_q: bool = dataclasses.field(metadata=dict(static=True), default=False)
    ifmr_kind: str = dataclasses.field(metadata=dict(static=True), default="linear")
    p_db: float = dataclasses.field(metadata=dict(static=True), default=0.1)
    # Quadrature refinement, same semantics as SinglePopModel.upsample.
    upsample: int = dataclasses.field(metadata=dict(static=True), default=1)


def make_multipop_model(
    grid: IsochroneGrid,
    stars: MSStars,
    prior_mean: np.ndarray,   # [12]
    prior_sigma: np.ndarray,  # [12]; <= 0 flat
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
) -> MultiPopModel:
    mz_grid = None
    if wd_stars is not None:
        if wd_cooling is None or wd_atm is None:
            raise ValueError("wd_stars requires wd_cooling and wd_atm grids")
        mz_grid = jnp.linspace(
            0.8, C.MAX_WD_PRECURSOR_MASS, n_mz, dtype=jnp.float32
        )
    return MultiPopModel(
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


def _lambda_mix(lam_c: Array, la: Array, lb: Array) -> Array:
    """Per-star log of lam * exp(la) + (1-lam) * exp(lb)."""
    a = jnp.log(lam_c) + la
    b = jnp.log1p(-lam_c) + lb
    m = jnp.maximum(a, b)
    return m + jnp.log(jnp.exp(a - m) + jnp.exp(b - m))


def _field_mix_total(stars: MSStars, log_clust: Array) -> Array:
    fa = stars.log_cm + log_clust
    fb = stars.log_1m_cm + stars.field_logdens
    mm = jnp.maximum(fa, fb)
    per_star = mm + jnp.log(jnp.exp(fa - mm) + jnp.exp(fb - mm))
    per_star = jnp.maximum(per_star, NEG_INF)
    return jnp.sum(per_star * stars.star_mask)


def log_lik(model: MultiPopModel, params: Array) -> tuple[Array, Array]:
    """Total per-star log likelihood and the bounds flag, separated from
    the prior so sharded runners can psum the star-sum across a mesh
    axis before adding the (replicated) prior — the same contract as
    posterior.log_lik, which is what lets parallel.run drive either
    model through one sharded machinery.  Returns (ll, in_bounds)."""
    age = params[C.Param.AGE]
    feh = params[C.Param.FEH]
    mod = params[C.Param.MOD]
    av = params[C.Param.ABS]
    ya = params[MP_YYA]
    yb = params[MP_YYB]
    lam = params[MP_LAMBDA]

    def marginals(y):
        base_iso = derive_isochrone(model.grid, feh, y, age)
        iso = base_iso
        if model.upsample > 1:
            from base_tpu.grids.isochrone import upsample_isochrone

            iso = upsample_isochrone(base_iso, model.upsample)
        table = lk.build_segment_table(
            iso, model.q_grid, mod, av, model.abs_coefs,
            binaries=model.binaries, uniform_q=model.uniform_q,
            sec_iso=base_iso,
        )
        # Normalized per population BEFORE the lambda mix — each
        # population's mass-prior normalizer Z differs (its own hull).
        lm = (lk.ms_log_marginals(model.stars, table)
              - lk.mass_prior_log_norm(table))
        return lm, iso.in_bounds

    la, in_a = marginals(ya)   # population A: fraction lambda
    lb, in_b = marginals(yb)   # population B: fraction 1 - lambda
    lam_c = jnp.clip(lam, 1e-6, 1.0 - 1e-6)
    log_clust = _lambda_mix(lam_c, la, lb)                     # [S]
    ll = _field_mix_total(model.stars, log_clust)

    if model.wd_stars is not None:
        # WD branch: each population's helium abundance changes the
        # precursor lifetime chain; the per-WD marginals mix with the
        # same lambda before the field mixture (SURVEY.md E2).
        from base_tpu.model import wd as wd_mod

        def wd_marginals(y):
            p = params.at[C.Param.YYY].set(y)
            mags, _, valid = wd_mod.wd_model_mags(
                model.grid, model.wd_cooling, model.wd_atm, p,
                model.mz_grid, model.ifmr_kind,
            )
            return wd_mod.wd_star_log_marginals(
                model.wd_stars, mags, valid, model.mz_grid, mod, av,
                model.abs_coefs, model.p_db,
            )

        wd_mix = _lambda_mix(lam_c, wd_marginals(ya), wd_marginals(yb))
        ll = ll + _field_mix_total(model.wd_stars, wd_mix)

    ok = in_a & in_b & (lam > 0.0) & (lam < 1.0)
    return ll, ok


def log_post(model: MultiPopModel, params: Array) -> Array:
    """Un-normalized log posterior of the 12-vector."""
    ll, ok = log_lik(model, params)
    lp = model.priors.log_prior(params)
    return jnp.where(ok, ll + lp, NEG_INF)


def make_logpost_fn(model: MultiPopModel):
    def f(params: Array) -> Array:
        return log_post(model, params)

    return f


def free_mask(model: MultiPopModel) -> tuple:
    """Sampled-parameter mask for HMCConfig.free_mask: the YYY slot is
    structurally unused here, and carbonicity/IFMR slots only matter
    with a WD branch — mirroring the MH path's step-scale-0 pinning
    [SURVEY.md §3.1]."""
    m = np.zeros(NPARAMS_MP, np.float32)
    m[[C.Param.AGE, C.Param.FEH, C.Param.MOD, C.Param.ABS]] = 1.0
    m[[MP_YYA, MP_YYB, MP_LAMBDA]] = 1.0
    if model.wd_stars is not None:
        m[C.Param.CARBONICITY] = 1.0
        if model.ifmr_kind in ("linear", "quadratic"):
            m[[C.Param.IFMR_INTERCEPT, C.Param.IFMR_SLOPE]] = 1.0
        if model.ifmr_kind == "quadratic":
            m[C.Param.IFMR_QUADCOEF] = 1.0
    return tuple(float(v) for v in m)


def _mp_bounds(model: MultiPopModel, margin: float):
    g = model.grid
    lo = np.full(NPARAMS_MP, -np.inf, np.float32)
    hi = np.full(NPARAMS_MP, np.inf, np.float32)

    def span(ax):
        a0, a1 = float(ax[0]), float(ax[-1])
        d = (a1 - a0) * margin
        return a0 + d, a1 - d

    lo[C.Param.AGE], hi[C.Param.AGE] = span(g.age)
    lo[C.Param.FEH], hi[C.Param.FEH] = span(g.feh)
    lo[C.Param.YYY], hi[C.Param.YYY] = span(g.y)   # unused slot, kept sane
    lo[C.Param.ABS], hi[C.Param.ABS] = 0.0, 10.0
    lo[C.Param.CARBONICITY], hi[C.Param.CARBONICITY] = 0.0, 1.0
    lo[MP_YYA], hi[MP_YYA] = span(g.y)
    lo[MP_YYB], hi[MP_YYB] = span(g.y)
    lo[MP_LAMBDA], hi[MP_LAMBDA] = 0.0, 1.0
    return lo, hi


def default_transform(model: MultiPopModel, margin: float = 1e-3):
    """12-vector interval transform; Y_A/Y_B independently bounded by the
    grid's Y hull (label-symmetric; see ordered_transform for the
    identifiable parameterization)."""
    lo, hi = _mp_bounds(model, margin)
    return make_interval_transform(lo, hi)


class OrderedMPTransform(NamedTuple):
    """Interval transform with the Y_A < Y_B ordering built into the
    bijection: Y_B = Y_A + (y_hi - Y_A) * sigmoid(z_B), so the sampler
    explores (Y_A, dY > 0) and the label-switching mode of the mixture is
    cut away by construction (VERDICT r1 #6; Stenning et al. 2016 order
    the helium abundances the same way).

    The Jacobian dx/dz is lower-triangular (Y_B depends on z_A and z_B),
    so the log-determinant is still the sum of the diagonal terms: the
    base terms for every slot except Y_B, plus
    log((y_hi - Y_A) * s * (1 - s)) for Y_B.
    """

    base: IntervalTransform   # Y_B slot marked unbounded (identity)
    y_hi: float

    def forward(self, z: Array) -> Array:
        x = self.base.forward(z)
        ya = x[..., MP_YYA]
        s = jnp.clip(jax_sigmoid(z[..., MP_YYB]), 1e-7, 1.0 - 1e-7)
        yb = ya + (self.y_hi - ya) * s
        return x.at[..., MP_YYB].set(yb)

    def inverse(self, x: Array) -> Array:
        z = self.base.inverse(x)
        ya = x[..., MP_YYA]
        u = (x[..., MP_YYB] - ya) / jnp.maximum(self.y_hi - ya, 1e-12)
        u = jnp.clip(u, 1e-7, 1.0 - 1e-7)
        return z.at[..., MP_YYB].set(jnp.log(u) - jnp.log1p(-u))

    def log_det_jacobian(self, z: Array) -> Array:
        ld = self.base.log_det_jacobian(z)
        ya = self.base.forward(z)[..., MP_YYA]
        s = jnp.clip(jax_sigmoid(z[..., MP_YYB]), 1e-7, 1.0 - 1e-7)
        return ld + (
            jnp.log(jnp.maximum(self.y_hi - ya, 1e-30))
            + jnp.log(s) + jnp.log1p(-s)
        )


def ordered_transform(model: MultiPopModel, margin: float = 1e-3):
    """The identifiable (Y_A, Y_B) parameterization: Y_A on the grid's Y
    hull, Y_B constrained to (Y_A, y_hi)."""
    lo, hi = _mp_bounds(model, margin)
    y_hi = float(hi[MP_YYB])
    lo[MP_YYB], hi[MP_YYB] = -np.inf, np.inf   # handled by the wrapper
    return OrderedMPTransform(
        base=make_interval_transform(lo, hi), y_hi=y_hi
    )


def make_logpost_z_fn(model: MultiPopModel, transform):
    def f(z: Array) -> Array:
        x = transform.forward(z)
        return log_post(model, x) + transform.log_det_jacobian(z)

    return f
