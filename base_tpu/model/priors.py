"""Prior densities: cluster-parameter priors and the stellar IMF.

Equivalent of the reference's density functions [upstream:
base9/densities.cpp logPriorClust / logPriorMass — SURVEY.md C9]:
Gaussian priors on [Fe/H], distance modulus, absorption (and optionally
any other parameter) with means/sigmas from config; flat-within-grid for
age and Y (enforced by the hull check / sampler transform, not here);
lognormal IMF on primary mass.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import Array

from base_tpu import constants as C

LN10 = 2.302585092994046


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClusterPriors:
    """Per-parameter Gaussian priors.  sigma <= 0 means flat (improper)."""

    mean: Array   # [NPARAMS]
    sigma: Array  # [NPARAMS]

    def log_prior(self, params: Array) -> Array:
        use = self.sigma > 0
        sig = jnp.where(use, self.sigma, 1.0)
        z = (params - self.mean) / sig
        terms = -0.5 * z * z - jnp.log(sig) - 0.9189385332046727
        return jnp.sum(jnp.where(use, terms, 0.0), axis=-1)


def log_imf(mass: Array) -> Array:
    """Lognormal IMF density in mass: log10 M ~ N(mean, sigma^2).

    p(M) dM = N(log10 M | mu, sig) dlog10 M  =>  p(M) includes 1/(M ln10).
    Constants per SURVEY.md C9 [M — re-verify vs base-cpp].
    """
    m = jnp.maximum(mass, 1e-6)
    lg = jnp.log10(m)
    z = (lg - C.IMF_LOG_MEAN) / C.IMF_LOG_SIGMA
    return (
        -0.5 * z * z
        - jnp.log(C.IMF_LOG_SIGMA)
        - 0.9189385332046727
        - jnp.log(m * LN10)
    )
