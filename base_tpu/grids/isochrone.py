"""Device-resident isochrone grids and EEP-aligned interpolation.

Replacement for the reference MS/RGB model hierarchy
[upstream: base9/MsRgbModels/*.{cpp,hpp}, base9/Isochrone.hpp — SURVEY.md
C5].  Where the C++ walks ragged per-(FeH,Y,age) isochrone vectors with
pointers, we rectangularize: every isochrone is padded to a common EEP
count E with a validity mask, so the whole model family is five dense
arrays that live in HBM and interpolate with gathers + FMAs (SURVEY.md §7
hard-part #2).

`derive_isochrone` is the analog of the reference's
`deriveIsochrone(feh, y, age)`: a 2x2x2 multilinear blend across the
(FeH, Y, logAge) axes, aligned by EEP index, producing the proposal
isochrone used by every star's likelihood.  It is pure, jittable, and
differentiable (piecewise-linear in the query point).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from base_tpu.ops import interp as iops

# Mass value assigned to padded (invalid) EEP slots; must exceed any real
# stellar mass and increase with slot index to keep searchsorted monotone.
PAD_MASS_BASE = 1.0e4


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IsochroneGrid:
    """Packed MS/RGB model family.

    Axes: feh [F], y [Y], age [A] (monotone increasing, log10 yr for age).
    mass  [F, Y, A, E]    initial (ZAMS) mass at each EEP, Msun
    mags  [F, Y, A, E, B] absolute magnitudes per band
    valid [F, Y, A, E]    1.0 where the EEP exists for this isochrone
    agb_tip [F, Y, A]     mass at the AGB tip (upper end of the isochrone)
    """

    feh: Array
    y: Array
    age: Array
    mass: Array
    mags: Array
    valid: Array
    agb_tip: Array
    bands: tuple[str, ...] = dataclasses.field(
        metadata=dict(static=True), default=()
    )
    name: str = dataclasses.field(metadata=dict(static=True), default="")

    @property
    def n_eep(self) -> int:
        return self.mass.shape[-1]

    @property
    def n_bands(self) -> int:
        return self.mags.shape[-1]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Isochrone:
    """One interpolated isochrone at a given (FeH, Y, logAge).

    mass_sorted pads invalid EEPs with huge increasing masses so that
    1-D mass->mags interpolation (secondaries, simulation) stays monotone.
    """

    mass: Array         # [E]
    mags: Array         # [E, B] absolute magnitudes
    valid: Array        # [E] {0., 1.}
    agb_tip: Array      # scalar
    in_bounds: Array    # scalar bool
    mass_sorted: Array  # [E] mass with pad slots pushed high
    min_mass: Array     # scalar: smallest valid mass on the isochrone

    def mags_at_mass(self, m: Array, smooth: bool = True) -> Array:
        """Piecewise-linear lookup of absolute mags at ZAMS mass m.

        Analog of the reference `msRgbEvol(mass)` [SURVEY.md C5].  Queries
        are clamped to the isochrone's mass hull; callers mask companions
        below `min_mass` or above `agb_tip` themselves.

        Dense (gather-free) formulation: the E*Q secondary-mass queries
        per proposal become hat-weights + one [Q,E]@[E,B] matrix product
        instead of searchsorted+gather (see ops.interp.hat_weight_matrix).

        smooth=True (smoothstep weights) is the default: the C^0 hat
        lookup puts gradient kinks in the log posterior at every node
        crossing of the E*Q secondary queries, capping the HMC step
        size ~50x below the posterior scale (ops.interp docstring).

        The SIMULATOR passes smooth=False: the marginal likelihood's
        segment-exact integral models magnitudes as piecewise-LINEAR in
        mass, so simulated single stars must be drawn from exactly that
        curve — a smoothstep draw against a linear likelihood biased
        the SBC modulus ranks one-sided.  Smoothing matters only where
        theta-gradients flow (the likelihood's secondary lookup).
        """
        return iops.interp1d_dense(self.mass_sorted, self.mags, m,
                                   smooth=smooth)


def derive_isochrone(grid: IsochroneGrid, feh, y, age) -> Isochrone:
    """EEP-aligned 2x2x2 interpolation over the (FeH, Y, logAge) axes.

    Dense (gather-free) formulation: per axis the boundary-clamped lerp
    weights are the hat basis evaluated at the query
    (ops.interp.hat_weight_matrix — nonzero only on the bracketing two
    nodes, so this is EXACTLY the 2x2x2 corner blend), and the blend is
    three tiny tensor contractions instead of a searchsorted per axis
    and 8 gathers per payload."""
    wf = iops.hat_weight_matrix(grid.feh, jnp.reshape(feh, (1,)))[0]
    wy = iops.hat_weight_matrix(grid.y, jnp.reshape(y, (1,)))[0]
    wa = iops.hat_weight_matrix(grid.age, jnp.reshape(age, (1,)))[0]
    inside = (
        (feh >= grid.feh[0]) & (feh <= grid.feh[-1])
        & (y >= grid.y[0]) & (y <= grid.y[-1])
        & (age >= grid.age[0]) & (age <= grid.age[-1])
    )
    w3 = wf[:, None, None] * wy[None, :, None] * wa[None, None, :]
    # Full float32 (a GPU would otherwise contract in TF32, ~1e-3
    # relative on the masses and so on every IMF weight).
    hi = jax.lax.Precision.HIGHEST
    mass = jnp.tensordot(w3, grid.mass, axes=3, precision=hi)   # [E]
    agb_tip = jnp.tensordot(w3, grid.agb_tip, axes=3, precision=hi)
    # Blend mags weighted by corner validity so that a padded corner does
    # not drag a valid EEP's magnitudes toward the pad values; weight
    # normalization = sum of w*valid (1 when all corners valid).
    wv3 = w3[..., None] * grid.valid                       # [F, Y, A, E]
    wv = jnp.sum(wv3, axis=(0, 1, 2))                      # [E]
    mags_num = jnp.einsum("fyae,fyaeb->eb", wv3, grid.mags, precision=hi)
    mags = mags_num / jnp.maximum(wv, 1e-12)[..., None]
    # An EEP is valid only when EVERY corner of the bracketing 2x2x2
    # cell is — including zero-weight corners at exact node hits, to
    # match the corner-gather semantics bit for bit.  Participation
    # one-hots come from locate (scalar searchsorted, no payload
    # gathers).
    def bracket(axis, q):
        idx = iops.locate(axis, q).idx
        ar = jnp.arange(axis.shape[0])
        return ((ar == idx) | (ar == idx + 1)).astype(grid.valid.dtype)

    p3 = (
        bracket(grid.feh, feh)[:, None, None]
        * bracket(grid.y, y)[None, :, None]
        * bracket(grid.age, age)[None, None, :]
    )[..., None]
    valid = 1.0 - jnp.max(p3 * (1.0 - grid.valid), axis=(0, 1, 2))

    e_idx = jnp.arange(mass.shape[0], dtype=mass.dtype)
    mass_sorted = jnp.where(valid > 0.5, mass, PAD_MASS_BASE + e_idx)
    min_mass = jnp.min(jnp.where(valid > 0.5, mass, PAD_MASS_BASE))
    return Isochrone(
        mass=mass,
        mags=mags,
        valid=valid,
        agb_tip=agb_tip,
        in_bounds=inside,
        mass_sorted=mass_sorted,
        min_mass=min_mass,
    )


def select_grid_bands(grid: IsochroneGrid, band_idx, bands) -> IsochroneGrid:
    """Restrict the grid to a band subset (dynamic filter selection).

    The reference's active filter set is the intersection of the .phot
    header and the model grid's bands [upstream: base9/Filters —
    SURVEY.md C13]; this is the grid side of that slice.
    """
    return dataclasses.replace(
        grid,
        mags=grid.mags[..., jnp.asarray(band_idx)],
        bands=tuple(bands),
    )


def upsample_isochrone(iso: Isochrone, factor: int) -> Isochrone:
    """Insert `factor - 1` linearly-interpolated nodes per EEP segment.

    The model magnitudes are piecewise-linear in mass (that is the
    interpolation model), so upsampling is exact — it only refines the
    mass-marginalization quadrature so that adjacent nodes differ by
    << sigma_obs in magnitude space.  Without this, the node-sum
    quadrature misses stars that sit between coarse EEPs (the integrand
    width in mass is ~ sigma / |dmag/dM|).
    """
    if factor <= 1:
        return iso
    E = iso.mass.shape[0]
    t = jnp.arange(factor, dtype=iso.mass.dtype) / factor  # [R]

    def lerp(a):  # a: [E, ...] -> [(E-1)*R + 1, ...]
        lo = a[:-1]
        hi = a[1:]
        tt = t.reshape((1, factor) + (1,) * (a.ndim - 1))
        seg = lo[:, None] * (1.0 - tt) + hi[:, None] * tt  # [E-1, R, ...]
        seg = seg.reshape((-1,) + a.shape[1:])
        return jnp.concatenate([seg, a[-1:]], axis=0)

    mass = lerp(iso.mass)
    mags = lerp(iso.mags)
    # A sub-node is valid only if both parent EEPs are valid (r > 0) or
    # the left parent is (r == 0).
    v_lo = iso.valid[:-1]
    v_hi = iso.valid[1:]
    both = jnp.minimum(v_lo, v_hi)
    seg_v = jnp.concatenate(
        [v_lo[:, None], jnp.broadcast_to(both[:, None], (E - 1, factor - 1))],
        axis=1,
    ).reshape(-1)
    valid = jnp.concatenate([seg_v, iso.valid[-1:]], axis=0)

    e_idx = jnp.arange(mass.shape[0], dtype=mass.dtype)
    mass_sorted = jnp.where(valid > 0.5, mass, PAD_MASS_BASE + e_idx)
    return Isochrone(
        mass=mass,
        mags=mags,
        valid=valid,
        agb_tip=iso.agb_tip,
        in_bounds=iso.in_bounds,
        mass_sorted=mass_sorted,
        min_mass=iso.min_mass,
    )


def eep_mass_weights(iso: Isochrone) -> Array:
    """Quadrature weights dM per EEP (central differences, masked).

    Equivalent of the reference's between-EEP dMass weights in
    margEvolveWithBinary [SURVEY.md C10].
    """
    m = iso.mass
    dm_fwd = jnp.diff(m, append=m[-1:])
    dm_bwd = jnp.diff(m, prepend=m[:1])
    dm = 0.5 * (jnp.abs(dm_fwd) + jnp.abs(dm_bwd))
    return jnp.where(iso.valid > 0.5, dm, 0.0)


def pack_ragged(
    feh_axis: np.ndarray,
    y_axis: np.ndarray,
    age_axis: np.ndarray,
    isochrones: dict,
    bands: Sequence[str],
    name: str = "",
) -> IsochroneGrid:
    """Pack a ragged {(fi, yi, ai): (mass[e], mags[e, B])} dict into dense
    arrays with validity masks.  Host-side (numpy), done once at load.
    """
    F, Y, A = len(feh_axis), len(y_axis), len(age_axis)
    E = max(v[0].shape[0] for v in isochrones.values())
    B = len(bands)
    mass = np.zeros((F, Y, A, E), np.float32)
    mags = np.zeros((F, Y, A, E, B), np.float32)
    valid = np.zeros((F, Y, A, E), np.float32)
    agb_tip = np.zeros((F, Y, A), np.float32)
    for (fi, yi, ai), (m, mg) in isochrones.items():
        n = m.shape[0]
        order = np.argsort(m, kind="stable")
        m, mg = m[order], mg[order]
        mass[fi, yi, ai, :n] = m
        mags[fi, yi, ai, :n] = mg
        valid[fi, yi, ai, :n] = 1.0
        agb_tip[fi, yi, ai] = m[-1]
        # Pad slots: repeat the tip mass region is wrong for searchsorted;
        # padded entries are masked at use sites, values irrelevant here.
        mass[fi, yi, ai, n:] = m[-1]
        mags[fi, yi, ai, n:] = mg[-1]
    return IsochroneGrid(
        feh=jnp.asarray(feh_axis, jnp.float32),
        y=jnp.asarray(y_axis, jnp.float32),
        age=jnp.asarray(age_axis, jnp.float32),
        mass=jnp.asarray(mass),
        mags=jnp.asarray(mags),
        valid=jnp.asarray(valid),
        agb_tip=jnp.asarray(agb_tip),
        bands=tuple(bands),
        name=name,
    )
