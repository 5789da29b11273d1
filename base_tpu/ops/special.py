"""Numerically-stable special ops used by the marginalized likelihood.

The reference accumulates exp(logPost) contributions in double precision
[upstream: base9/marg.cpp — SURVEY.md C10]; here we work in float32 and
use max-shifted logsumexp with explicit masking so that padded EEP /
quadrature slots contribute exactly zero probability (not -inf * 0 NaNs,
the hazard flagged in SURVEY.md §7 "hard parts" #2).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array

NEG_INF = -1e30  # finite stand-in for -inf: keeps gradients NaN-free


def masked_logsumexp(x: Array, mask: Array, axis=-1) -> Array:
    """log(sum_i mask_i * exp(x_i)) along `axis`, safe for all-masked rows.

    mask is boolean (or {0,1} float).  Rows with no valid entries return
    NEG_INF (a large negative float32, not -inf) so downstream sums stay
    finite and differentiable.
    """
    neg = jnp.asarray(NEG_INF, dtype=x.dtype)
    x = jnp.where(mask, x, neg)
    m = jnp.max(x, axis=axis, keepdims=True)
    m = jnp.maximum(m, neg)  # all-masked rows: avoid -inf shift
    s = jnp.sum(jnp.where(mask, jnp.exp(x - m), 0.0), axis=axis)
    out = jnp.squeeze(m, axis=axis) + jnp.log(jnp.maximum(s, 1e-38))
    return jnp.where(s > 0, out, neg)


def logaddexp(a: Array, b: Array) -> Array:
    """Stable log(e^a + e^b) tolerant of NEG_INF sentinels."""
    m = jnp.maximum(a, b)
    return m + jnp.log1p(jnp.exp(-jnp.abs(a - b)))


def log_gaussian(x: Array, mean: Array, sigma: Array) -> Array:
    """Elementwise log N(x | mean, sigma^2)."""
    z = (x - mean) / sigma
    return -0.5 * z * z - jnp.log(sigma) - 0.9189385332046727


# --- Gaussian interval mass, float32-robust, kernel-safe ---------------------

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _erf_poly_from_e(ax: Array, e: Array) -> Array:
    """erf(|x|) via Abramowitz-Stegun 7.1.26 given e = exp(-x^2)
    (|abs err| <= 1.5e-7).  Kernel-safe: mul/add only."""
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (
        0.254829592
        + t * (-0.284496736
               + t * (1.421413741
                      + t * (-1.453152027 + t * 1.061405429)))
    )
    return 1.0 - poly * e


def phi_interval_scaled(u0: Array, u1: Array) -> tuple[Array, Array]:
    """(D_scaled, u_near_sq) with D_scaled = (Phi(u1) - Phi(u0)) *
    exp(u_near^2 / 2), for u1 >= u0, elementwise, float32-robust.

    u_near^2 = min(u0^2, u1^2) when the interval is one-sided (0 outside
    it), so D_scaled is O(1) — NEVER exponentially small — and the
    caller absorbs exp(-u_near^2/2) into its max-shifted exponent
    exactly (chi2 at the nearest segment endpoint = residual +
    u_near^2).  Two regimes sharing the same exp evaluations:
    - interval touching the bulk (|u_near| < 3.5): direct erf difference
      (A-S polynomial, absolute error ~3e-7, relatively fine because the
      difference is >~1e-4 here), times exp(u_near^2/2) <= e^6.2;
    - one-sided far-tail interval: erf cancels catastrophically, so use
      the Mills asymptotic: Q(u) e^{u^2/2} = phi(0) / u (1 - 1/u^2 +
      3/u^4) — the scaling cancels the tiny exponential analytically.
    Kernel-safe throughout (no erf/erfc primitives, which Pallas's
    Triton route does not lower).
    """
    x0 = u0 * _INV_SQRT2
    x1 = u1 * _INV_SQRT2
    e0 = jnp.exp(-x0 * x0)   # = exp(-u0^2 / 2)
    e1 = jnp.exp(-x1 * x1)
    erf0 = jnp.sign(x0) * _erf_poly_from_e(jnp.abs(x0), e0)
    erf1 = jnp.sign(x1) * _erf_poly_from_e(jnp.abs(x1), e1)
    d_erf = jnp.maximum(0.5 * (erf1 - erf0), 0.0)

    one_sided = (u0 * u1) > 0.0
    unear_sq = jnp.where(
        one_sided, jnp.minimum(u0 * u0, u1 * u1), 0.0
    )
    # erf branch scale factor; clamp so the unselected branch stays
    # finite (0 * inf = NaN hazard in the VJP otherwise).
    erf_scale = jnp.exp(0.5 * jnp.minimum(unear_sq, 13.0))

    def mills_scaled(u_abs, extra_log):
        # Q(|u|) * e^{u_near^2/2} with u_near <= u: phi(0)/u * series *
        # exp(-(u^2 - u_near^2)/2); the exponent is <= 0.
        u = jnp.maximum(u_abs, 1.0)
        iu2 = 1.0 / (u * u)
        series = 1.0 - iu2 + 3.0 * iu2 * iu2
        return _INV_SQRT_2PI / u * series * jnp.exp(
            jnp.minimum(extra_log, 0.0)
        )

    right = u0 > 3.5    # Phi(u1)-Phi(u0) = Q(u0) - Q(u1)
    left = u1 < -3.5    # = Q(|u1|) - Q(|u0|) by symmetry
    au0 = jnp.abs(u0)
    au1 = jnp.abs(u1)
    u_near = jnp.where(right, au0, au1)
    u_far = jnp.where(right, au1, au0)
    m_near = mills_scaled(u_near, 0.0)
    m_far = mills_scaled(u_far, 0.5 * (unear_sq - u_far * u_far))
    d_asym = jnp.maximum(m_near - m_far, 0.0)
    d = jnp.where(right | left, d_asym, d_erf * erf_scale)
    return d, unear_sq


def phi_interval(u0: Array, u1: Array) -> Array:
    """Phi(u1) - Phi(u0) for u1 >= u0 (unscaled convenience wrapper;
    underflows to 0 in far tails — prefer phi_interval_scaled in
    accumulation loops)."""
    d, unear_sq = phi_interval_scaled(u0, u1)
    return d * jnp.exp(-0.5 * unear_sq)
