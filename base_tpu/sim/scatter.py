"""Photometric noise model — the scatterCluster equivalent.

Rebuild of the reference's noise stage [upstream:
scatterCluster/ — SURVEY.md E4, §3.3]: per-band magnitude-dependent
Gaussian uncertainties from an S/N-vs-magnitude model with per-band
exposure times, and bright/faint cutoffs applied on a designated
"relevant filter" (the reference's relevantFilt column), emitting
sampler-ready photometry (sigma < 0 marks a band unobserved, matching
the .phot convention [SURVEY.md C14]).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
from jax import Array


class ScatteredCatalog(NamedTuple):
    mags: Array    # [S, B] noisy apparent magnitudes
    sigmas: Array  # [S, B]; <= 0 where unobserved (outside cutoffs)


def sigma_model(
    mags: Array,
    limit_mag: Array | float = 22.0,
    sigma_floor: float = 0.01,
) -> Array:
    """Photometric uncertainty vs magnitude.

    sigma(m) = sigma_floor + exp(1.09 (m - limit));  ~sigma_floor for
    bright stars, ~0.1 mag near the survey limit — the usual background-
    limited error curve shape (reference: per-band exposure-time S/N
    model [SURVEY.md E4]).  `limit_mag` may be per-band [B].
    """
    return sigma_floor + jnp.exp(1.09 * (mags - limit_mag))


def exposure_limits(
    exposures: Sequence[float] | Array, base_limit: float = 22.0
) -> Array:
    """Per-band limiting magnitudes from exposure times (hours-like
    units): background-limited depth gains 1.25 log10(t) mag — the
    reference's exposures section maps to this [SURVEY.md C12
    scatterCluster.exposures]."""
    t = jnp.asarray(exposures, jnp.float32)
    return base_limit + 1.25 * jnp.log10(jnp.maximum(t, 1e-6))


def scatter_cluster(
    mags: Array,
    key,
    limit_mag: Array | float = 22.0,
    bright_limit: float = -10.0,
    faint_limit: float = 30.0,
    sigma_floor: float = 0.01,
    relevant_filt: int | None = None,
    censor: bool = True,
) -> ScatteredCatalog:
    """Add noise + apply cutoffs.

    Per-band behavior: a band is unobserved (sigma < 0) when its noisy
    magnitude exceeds its own limit by > 1 mag.  Row behavior: when
    `relevant_filt` is given, the bright/faint limits cut on THAT band
    only and blank the whole star (reference semantics); otherwise the
    limits apply band-wise.

    censor=False keeps every band observed (noise still follows the
    S/N model, so bands past the limit carry ~mag-scale sigmas and
    almost no information).  Detection cuts on the NOISY magnitude are
    a Malmquist truncation the Gaussian likelihood does not model
    (kept faint stars are preferentially up-fluctuated); measured at
    the acceptance-scenario configs it censors 0-0.4% of bands
    (scripts/bias_study.py censor: zero drift change at limit 26), so
    it is a sub-sigma effect there — but self-consistency artifacts
    (SBC, truth-recovery) generate from the exact model class they
    fit, so they pass censor=False on principle.  Survey pipelines
    that DO cut at the limit inherit the same un-modeled truncation
    the reference has [upstream: scatterCluster cutoffs, SURVEY.md
    E4].
    """
    sig = sigma_model(mags, limit_mag, sigma_floor)
    noisy = mags + sig * jax.random.normal(key, mags.shape)
    if not censor:
        return ScatteredCatalog(mags=noisy, sigmas=sig)
    detected = noisy < (jnp.asarray(limit_mag) + 1.0)
    if relevant_filt is None:
        in_cut = (noisy > bright_limit) & (noisy < faint_limit)
    else:
        rf = noisy[:, relevant_filt]
        in_cut = ((rf > bright_limit) & (rf < faint_limit))[:, None]
    observed = detected & in_cut
    return ScatteredCatalog(
        mags=jnp.where(observed, noisy, 99.0),
        sigmas=jnp.where(observed, sig, -9.0),
    )
