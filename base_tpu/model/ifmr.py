"""Initial-final mass relations (ZAMS mass -> WD mass).

Equivalent of the reference IFMR component [upstream:
base9/IFMR.cpp intlFinalMassReln — SURVEY.md C8]: fixed published
relations plus the *tunable* linear/quadratic whose coefficients are
cluster parameters 7-9 (the IFMR science case, BASELINE.json:9).  All
closed-form jnp, differentiable in both mass and the coefficients.

Published-relation coefficients are literature values [M confidence —
re-verify against base-cpp per SURVEY.md §7 step 0]:
  Weidemann 2000:   m_wd = 0.109 m + 0.394
  Williams+ 2009:   m_wd = 0.339 + 0.129 m
  Salaris+ 2009 linear:     m_wd = 0.466 + 0.084 m
  Salaris+ 2009 piecewise:  m < 4: 0.331 + 0.134 m;  m >= 4: 0.679 + 0.047 m
Tunable relations are centered on a 3 Msun pivot so the intercept
parameter is the WD mass of a 3 Msun progenitor:
  linear:    m_wd = b0 + b1 (m - 3)
  quadratic: m_wd = b0 + b1 (m - 3) + b2 (m - 3)^2
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from base_tpu import constants as C

IFMR_PIVOT = 3.0

FIXED_IFMRS = ("weidemann", "williams", "salaris_lin", "salaris_pw")
TUNABLE_IFMRS = ("linear", "quadratic")


def ifmr_mass(kind: str, zams_mass: Array, params: Array) -> Array:
    """WD mass for progenitor `zams_mass` under relation `kind`.

    `params` is the 9-vector; only the IFMR slots are read (and only for
    tunable kinds).  `kind` is static (selected from Settings).
    """
    m = zams_mass
    if kind == "weidemann":
        return 0.394 + 0.109 * m
    if kind == "williams":
        return 0.339 + 0.129 * m
    if kind == "salaris_lin":
        return 0.466 + 0.084 * m
    if kind == "salaris_pw":
        lo = 0.331 + 0.134 * m
        hi = 0.679 + 0.047 * m
        return jnp.where(m < 4.0, lo, hi)
    b0 = params[C.Param.IFMR_INTERCEPT]
    b1 = params[C.Param.IFMR_SLOPE]
    d = m - IFMR_PIVOT
    if kind == "linear":
        return b0 + b1 * d
    if kind == "quadratic":
        b2 = params[C.Param.IFMR_QUADCOEF]
        return b0 + b1 * d + b2 * d * d
    raise ValueError(f"unknown IFMR kind: {kind}")


def default_ifmr_start() -> tuple[float, float, float]:
    """Sensible tunable-IFMR starting coefficients (matches Weidemann at
    the pivot)."""
    return (0.394 + 0.109 * IFMR_PIVOT, 0.109, 0.0)
