"""White-dwarf cooling-model grids: (carbonicity, WD mass, cooling age)
-> (log Teff, log radius).

Replacement for the reference WD cooling hierarchy [upstream:
base9/WdCoolingModels/{Wood,Montgomery,Althaus,Renedo}*.cpp — SURVEY.md
C6].  The C++ walks per-mass cooling tracks and interpolates along each,
then across mass (Montgomery also across carbonicity); here every family
is one dense rectangular table on (x = carbonicity, m = WD mass,
a = log10 cooling age) axes with trilinear interpolation — non-Montgomery
families carry a length-1 carbonicity axis and the interpolation
degenerates to bilinear for free.

Real grid files drop in via `pack` once model data is available
(SURVEY.md §7 step 0); offline, `synthetic_wd_cooling` generates a
smooth Mestel-like family with the same structure.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from base_tpu.ops import interp as iops


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WdCoolingGrid:
    carb: Array       # [X] carbonicity axis (len 1 if family has none)
    mass: Array       # [M] WD mass axis, Msun
    log_age: Array    # [A] log10 cooling age [yr]
    log_teff: Array   # [X, M, A]
    log_radius: Array # [X, M, A] log10(R / Rsun)
    name: str = dataclasses.field(metadata=dict(static=True), default="")


def wd_teff_radius(
    grid: WdCoolingGrid, carbonicity, wd_mass, log_cool_age
):
    """Trilinear (log Teff, log R, in_bounds) at one query point.

    Analog of the reference `wdMassToTeffAndRadius` [SURVEY.md C6].
    Carbonicity queries on a length-1 axis clamp to that plane (the
    non-Montgomery behavior).
    """
    axes = (grid.carb, grid.mass, grid.log_age)
    point = (carbonicity, wd_mass, log_cool_age)
    if grid.carb.shape[0] == 1:
        # Degenerate axis: clamp and drop from the interpolation.
        lt, inside = iops.multilinear(
            axes[1:], grid.log_teff[0], point[1:]
        )
        lr, _ = iops.multilinear(axes[1:], grid.log_radius[0], point[1:])
        return lt, lr, inside
    lt, inside = iops.multilinear(axes, grid.log_teff, point)
    lr, _ = iops.multilinear(axes, grid.log_radius, point)
    return lt, lr, inside


def synthetic_wd_cooling(
    n_mass: int = 12,
    n_age: int = 40,
    with_carbonicity: bool = True,
    name: str = "synthetic-montgomery",
) -> WdCoolingGrid:
    """Smooth toy cooling physics (Mestel-law shape):

      log L/Lsun = -0.2 - 1.4 (log t_cool - 6) / 2.5 + 0.4 (M - 0.6)
      log R/Rsun = -1.93 - 0.4 (M - 0.6) (+ tiny age contraction)
      log Teff   = (log L - 2 log R) / 4 + log Teff_sun
      carbonicity x shifts the cooling rate: + 0.03 (x - 0.5) in log L.
    """
    carb = (
        np.linspace(0.0, 1.0, 5, dtype=np.float32)
        if with_carbonicity
        else np.array([0.5], np.float32)
    )
    mass = np.linspace(0.4, 1.2, n_mass, dtype=np.float32)
    log_age = np.linspace(5.0, 10.2, n_age, dtype=np.float32)
    X, M, A = np.meshgrid(carb, mass, log_age, indexing="ij")
    logL = -0.2 - 1.4 * (A - 6.0) / 2.5 + 0.4 * (M - 0.6) + 0.03 * (X - 0.5) * (A - 6.0)
    logR = -1.93 - 0.4 * (M - 0.6) - 0.002 * (A - 6.0)
    log_teff_sun = 3.7615
    logTe = 0.25 * (logL - 2.0 * logR) + log_teff_sun
    return WdCoolingGrid(
        carb=jnp.asarray(carb),
        mass=jnp.asarray(mass),
        log_age=jnp.asarray(log_age),
        log_teff=jnp.asarray(logTe, jnp.float32),
        log_radius=jnp.asarray(logR, jnp.float32),
        name=name,
    )


def pack(
    carb_axis: np.ndarray,
    mass_axis: np.ndarray,
    log_age_axis: np.ndarray,
    log_teff: np.ndarray,
    log_radius: np.ndarray,
    name: str = "",
) -> WdCoolingGrid:
    """Pack externally-parsed cooling tables (already rectangularized on
    a common log-age axis; re-grid ragged tracks host-side first)."""
    return WdCoolingGrid(
        carb=jnp.asarray(carb_axis, jnp.float32),
        mass=jnp.asarray(mass_axis, jnp.float32),
        log_age=jnp.asarray(log_age_axis, jnp.float32),
        log_teff=jnp.asarray(log_teff, jnp.float32),
        log_radius=jnp.asarray(log_radius, jnp.float32),
        name=name,
    )
