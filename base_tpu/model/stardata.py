"""Per-star observation containers, precomputed for the likelihood.

Equivalent of the reference's Star/StellarSystem state
[upstream: base9/Star.cpp, base9/StellarSystem.cpp — SURVEY.md C3], but
organized as struct-of-arrays: the per-band Gaussian log-likelihood of S
stars against T model points evaluates as one dense masked broadcast-
reduce (or a matrix-product variant for wide band sets) instead of the
reference's per-star scalar loops.  Unobserved bands (sigma <= 0 in the
.phot file) simply carry 1/s^2 = 0.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

LOG_SQRT_2PI = 0.9189385332046727


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MSStars:
    """Main-sequence/RGB stars (status MSRG), padded to a static S.

    obs_over_var [S, B] : o_b / s_b^2            (0 where unobserved)
    inv_var      [S, B] : 1 / s_b^2              (0 where unobserved)
    c0           [S]    : sum_b o_b^2 / s_b^2
    log_norm     [S]    : sum_obs_b (-log s_b - log sqrt(2 pi))
    log_cm       [S]    : log of cluster-membership prior weight
    log_1m_cm    [S]    : log(1 - membership prior)
    field_logdens[S]    : log uniform CMD density for the field component
    star_mask    [S]    : 1.0 for real stars, 0.0 for padding
    obs_mags     [S, B] : raw magnitudes (kept for simulation/round-trips)
    obs_sigma    [S, B] : raw uncertainties (<=0 means unobserved)
    """

    obs_over_var: Array
    inv_var: Array
    c0: Array
    log_norm: Array
    log_cm: Array
    log_1m_cm: Array
    field_logdens: Array
    star_mask: Array
    obs_mags: Array
    obs_sigma: Array

    @property
    def n_stars(self) -> int:
        return self.obs_mags.shape[0]

    @property
    def n_bands(self) -> int:
        return self.obs_mags.shape[1]


def make_ms_stars(
    mags: np.ndarray,
    sigmas: np.ndarray,
    cm_prior: np.ndarray | float = 0.999,
    field_mag_range: np.ndarray | float = 20.0,
    pad_to: int | None = None,
    sigma_model: float = 0.0,
) -> MSStars:
    """Build the MS-star container from raw photometry (host side).

    cm_prior mirrors the .phot CMprior column [SURVEY.md C14]; the
    field-star component is a uniform density over a CMD box of side
    `field_mag_range` mag in each observed band [upstream: base9/densities
    field-star mixture — SURVEY.md C9].  Pass a [B] array for per-band
    box widths (e.g. `sim.simulate.field_cmd_box` spans) — a field
    density mis-normalized relative to the true field distribution
    skews the membership mixture and with it the cluster parameters.

    sigma_model is a model-discretization floor added in quadrature to
    the observational uncertainties (sigma_eff^2 = sigma^2 +
    sigma_model^2): the mass marginalization evaluates the isochrone at
    discrete quadrature nodes, and magnitudes should not be trusted below
    the node spacing.  Pair it with the table's `upsample` factor.
    """
    mags = np.asarray(mags, np.float32)
    sigmas = np.asarray(sigmas, np.float32)
    S, B = mags.shape
    cm = np.broadcast_to(np.asarray(cm_prior, np.float32), (S,)).copy()
    cm = np.clip(cm, 1e-6, 1.0 - 1e-6)

    observed = sigmas > 0
    sig_eff = np.sqrt(np.maximum(sigmas, 1e-12) ** 2 + sigma_model**2)
    sigmas_eff = np.where(observed, sig_eff, sigmas)
    inv_var = np.where(observed, 1.0 / sigmas_eff**2, 0.0)
    obs_over_var = np.where(observed, mags * inv_var, 0.0)
    c0 = (np.where(observed, mags**2 * inv_var, 0.0)).sum(-1)
    log_norm = np.where(
        observed, -np.log(np.maximum(sigmas_eff, 1e-12)) - LOG_SQRT_2PI, 0.0
    ).sum(-1)
    rng = np.broadcast_to(np.asarray(field_mag_range, np.float32), (B,))
    field_logdens = -np.where(observed, np.log(rng)[None, :], 0.0).sum(-1)

    if pad_to is None:
        pad_to = S
    P = max(pad_to - S, 0)

    def pad(x, val=0.0):
        w = [(0, P)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, w, constant_values=val)

    return MSStars(
        obs_over_var=jnp.asarray(pad(obs_over_var)),
        inv_var=jnp.asarray(pad(inv_var)),
        c0=jnp.asarray(pad(c0)),
        log_norm=jnp.asarray(pad(log_norm)),
        log_cm=jnp.asarray(pad(np.log(cm), val=-1.0)),
        log_1m_cm=jnp.asarray(pad(np.log1p(-cm), val=-1.0)),
        field_logdens=jnp.asarray(pad(field_logdens.astype(np.float32))),
        star_mask=jnp.asarray(pad(np.ones(S, np.float32))),
        obs_mags=jnp.asarray(pad(mags)),
        obs_sigma=jnp.asarray(pad(sigmas, val=-9.0)),
    )
