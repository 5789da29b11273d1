"""Regular-grid multilinear interpolation primitives.

Replacement for the reference's pointer-walking 2x2x2 corner
interpolation [upstream: base9/MsRgbModels/GenericMsModel.cpp — SURVEY.md
C5].  Design notes:

- Axes are small 1-D monotone arrays living in device memory; locating a
  query is a `searchsorted` (tiny) and the blend is a static Python loop
  over the 2^k corners, which XLA fuses into a handful of gathers + FMAs.
- Everything is differentiable: gradients flow through the lerp weights
  (piecewise-linear in the query), which is exactly what HMC/NUTS needs.
- Out-of-bounds queries are clamped to the boundary cell; callers receive
  an `in_bounds` flag so the log-density can veto (-inf) or the transform
  layer can keep samplers inside the hull.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
from jax import Array


class AxisLoc(NamedTuple):
    """Location of a query on one grid axis."""

    idx: Array   # int32, lower corner index in [0, len(axis)-2]
    frac: Array  # lerp weight, clamped to [0, 1] for blending
    inside: Array  # bool, True when the raw query was within the axis hull


def locate(axis: Array, x: Array) -> AxisLoc:
    """Find the cell of `x` on a monotone-increasing 1-D `axis`."""
    n = axis.shape[0]
    idx = jnp.clip(jnp.searchsorted(axis, x, side="right") - 1, 0, n - 2)
    lo = axis[idx]
    hi = axis[idx + 1]
    frac_raw = (x - lo) / (hi - lo)
    inside = (x >= axis[0]) & (x <= axis[-1])
    return AxisLoc(idx.astype(jnp.int32), jnp.clip(frac_raw, 0.0, 1.0), inside)


def multilinear(
    axes: Sequence[Array],
    values: Array,
    point: Sequence[Array],
):
    """Multilinear interpolation of `values` on a tensor-product grid.

    axes:   k monotone 1-D arrays, lengths (n_0, ..., n_{k-1})
    values: array with leading shape (n_0, ..., n_{k-1}) + trailing payload
    point:  k scalars (or broadcastable arrays; scalar use is typical —
            vmap for batches)

    Returns (interpolated payload, in_bounds flag).
    """
    k = len(axes)
    locs = [locate(a, p) for a, p in zip(axes, point)]
    inside = locs[0].inside
    for l in locs[1:]:
        inside = inside & l.inside

    out = None
    for corner in range(1 << k):
        idx = tuple(
            locs[d].idx + ((corner >> d) & 1) for d in range(k)
        )
        w = 1.0
        for d in range(k):
            t = locs[d].frac
            w = w * jnp.where((corner >> d) & 1, t, 1.0 - t)
        term = values[idx] * w
        out = term if out is None else out + term
    return out, inside


def gather_corners(axes: Sequence[Array], point: Sequence[Array]):
    """Return (corner index tuples, corner weights, in_bounds).

    Used when several payload arrays share the same grid axes (mass, mags,
    validity mask of an isochrone grid): locate once, blend many.
    """
    k = len(axes)
    locs = [locate(a, p) for a, p in zip(axes, point)]
    inside = locs[0].inside
    for l in locs[1:]:
        inside = inside & l.inside

    corners = []
    weights = []
    for corner in range(1 << k):
        idx = tuple(locs[d].idx + ((corner >> d) & 1) for d in range(k))
        w = 1.0
        for d in range(k):
            t = locs[d].frac
            w = w * jnp.where((corner >> d) & 1, t, 1.0 - t)
        corners.append(idx)
        weights.append(w)
    return corners, weights, inside


def blend(corners, weights, values: Array) -> Array:
    """Blend payload `values` over precomputed corners/weights."""
    out = None
    for idx, w in zip(corners, weights):
        term = values[idx] * w
        out = term if out is None else out + term
    return out


def interp1d(x_axis: Array, y: Array, xq: Array) -> Array:
    """Piecewise-linear 1-D interpolation with boundary clamping.

    y may have trailing payload dims; y.shape[0] == x_axis.shape[0].
    xq may be any shape; result has shape xq.shape + y.shape[1:].
    Monotone-increasing x_axis required.
    """
    loc = locate(x_axis, xq)
    lo = y[loc.idx]
    hi = y[loc.idx + 1]
    t = loc.frac
    # Broadcast frac over payload dims.
    t = t.reshape(t.shape + (1,) * (y.ndim - 1))
    return lo + (hi - lo) * t


_HUGE = 1.0e30  # virtual axis extension for boundary clamping


def hat_weight_matrix(x_axis: Array, xq: Array,
                      smooth: bool = False) -> Array:
    """Dense piecewise-linear interpolation weights W [Q, E].

    y(xq) == W @ y exactly (same lerp as interp1d, boundary-clamped),
    but expressed gather-free: each row of W is the hat-function basis
    evaluated at one query, via the identity

        w_e(x) = clip((x - x_{e-1}) / (x_e - x_{e-1}), 0, 1)
               + clip((x_{e+1} - x) / (x_{e+1} - x_e), 0, 1) - 1

    with the axis virtually extended by +-1e30 so the first/last hats
    saturate to 1 outside the hull (= clamping).  This replaces
    searchsorted (a sequential binary-search loop of batched gathers)
    and payload gathers with one [Q, E] compare/FMA block and one
    [Q, E] @ [E, B] matrix product.

    Differentiable in BOTH xq and x_axis (the isochrone masses are
    proposal-dependent, so gradients must flow into the axis).

    `smooth=True` replaces the clip by the symmetric smoothstep
    S(t) = t^2 (3 - 2t): because S(1 - t) = 1 - S(t), the weights still
    sum to exactly 1 and still hit the node values exactly, but the
    interpolant becomes C^1 in the query (and in the axis).  This is the
    HMC-critical variant: with plain hats, every secondary-mass query
    crossing a node is a gradient kink in the log posterior, and the
    E*Q crossings put kinks at ~1e-3 parameter scale that cap the
    stable leapfrog step far below the posterior scale (measured: slope
    jumps O(100-400) in d logpost / d age).  The weights stay in [0, 1]
    and bracket the same two nodes, so there is no overshoot and no
    change to hull clamping.
    """
    E = x_axis.shape[0]
    ext_lo = x_axis[:1] - _HUGE
    ext_hi = x_axis[-1:] + _HUGE
    xl = jnp.concatenate([ext_lo, x_axis[:-1]])   # x_{e-1}, [E]
    xr = jnp.concatenate([x_axis[1:], ext_hi])    # x_{e+1}, [E]
    dl = jnp.maximum(x_axis - xl, 1e-30)
    dr = jnp.maximum(xr - x_axis, 1e-30)
    q = xq.reshape(-1)                             # [Q]
    up = jnp.clip((q[:, None] - xl[None, :]) / dl[None, :], 0.0, 1.0)
    dn = jnp.clip((xr[None, :] - q[:, None]) / dr[None, :], 0.0, 1.0)
    if smooth:
        up = up * up * (3.0 - 2.0 * up)
        dn = dn * dn * (3.0 - 2.0 * dn)
    w = up + dn - 1.0
    return w.reshape(xq.shape + (E,))


def interp1d_dense(x_axis: Array, y: Array, xq: Array,
                   smooth: bool = False) -> Array:
    """interp1d via hat_weight_matrix: W @ y as a matrix product, no
    gathers.

    Numerically identical to interp1d up to float32 reassociation; use
    on hot paths where xq is a large batch against a small axis.

    Precision MUST be HIGHEST here: a GPU would otherwise be free to run
    the product in TF32, whose 10-bit mantissa gives ~1e-3 relative
    error on the interpolated magnitudes (~0.02 mag at mag 20) —
    comparable to the photometric sigmas (0.01-0.1 mag).  The density
    would become jagged at that quantization scale and HMC chains
    freeze."""
    w = hat_weight_matrix(x_axis, xq, smooth=smooth)  # [..., E]
    y2 = y.reshape(y.shape[0], -1)                 # [E, P]
    out = jnp.dot(
        w.reshape(-1, w.shape[-1]), y2,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.reshape(xq.shape + y.shape[1:])
