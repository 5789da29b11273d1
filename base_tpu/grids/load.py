"""Model-grid loading: the Model-bundle factory.

Equivalent of the reference model factory [upstream:
base9/Model.cpp makeModel(Settings) — SURVEY.md C4]: Settings names an
MS/RGB family, a WD cooling family, a WD atmosphere model and an IFMR;
this module materializes device-resident grids for each.

Grid data files are distributed separately from the reference code (the
`modelDirectory` download, SURVEY.md L0) and are unavailable offline, so
families load from:
  1. `<modelDirectory>/<family>.npz` — our packed container (axes +
     dense arrays; see pack_ragged / wd_cooling.pack), produced by a
     one-time conversion of the upstream text grids when data exists;
  2. the procedural synthetic family (same structure) otherwise.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from base_tpu.grids import synthetic
from base_tpu.grids import wd_atmosphere as wda
from base_tpu.grids import wd_cooling as wdc
from base_tpu.grids.isochrone import IsochroneGrid
from base_tpu.io.settings import Settings

MS_FAMILIES = ("girardi", "dsed", "yale", "synthetic")
WD_FAMILIES = ("wood", "montgomery", "althaus", "renedo", "synthetic")


class ModelBundle(NamedTuple):
    """One resolved model set (the reference `Model` struct analog)."""

    ms: IsochroneGrid
    wd_cooling: wdc.WdCoolingGrid
    wd_atm: wda.WdAtmosphereGrid
    ifmr_kind: str


def _npz_path(model_dir: str, family: str) -> str | None:
    if not model_dir:
        return None
    p = os.path.join(model_dir, f"{family}.npz")
    return p if os.path.exists(p) else None


def load_ms_grid(settings: Settings) -> IsochroneGrid:
    family = settings.models.msRgbModel.lower()
    if family not in MS_FAMILIES:
        raise ValueError(f"unknown msRgbModel {family}; one of {MS_FAMILIES}")
    path = _npz_path(settings.files.modelDirectory, family)
    if path:
        return load_packed_isochrones(path, name=family)
    # Procedural fallback: per-family axes spans differ slightly so the
    # families are distinguishable in tests.
    spans = {
        "girardi": dict(feh=(-2.0, 0.4, 5), y=(0.23, 0.32, 4), age=(8.4, 10.2, 10)),
        "dsed": dict(feh=(-2.2, 0.5, 6), y=(0.24, 0.33, 4), age=(8.6, 10.15, 9)),
        "yale": dict(feh=(-1.8, 0.3, 5), y=(0.22, 0.34, 5), age=(8.5, 10.1, 9)),
        "synthetic": dict(feh=(-2.0, 0.4, 5), y=(0.22, 0.33, 4), age=(8.4, 10.2, 10)),
    }[family]
    return synthetic.make_grid(
        feh_axis=np.linspace(*spans["feh"]),
        y_axis=np.linspace(*spans["y"]),
        age_axis=np.linspace(*spans["age"]),
        bands=tuple(settings.models.bands),
        name=f"synthetic-{family}",
    )


def load_packed_isochrones(path: str, name: str = "") -> IsochroneGrid:
    """Load a packed .npz isochrone container (our on-disk format)."""
    import jax.numpy as jnp

    z = np.load(path, allow_pickle=False)
    return IsochroneGrid(
        feh=jnp.asarray(z["feh"]),
        y=jnp.asarray(z["y"]),
        age=jnp.asarray(z["age"]),
        mass=jnp.asarray(z["mass"]),
        mags=jnp.asarray(z["mags"]),
        valid=jnp.asarray(z["valid"]),
        agb_tip=jnp.asarray(z["agb_tip"]),
        bands=tuple(str(b) for b in z["bands"]),
        name=name or str(path),
    )


def save_packed_isochrones(path: str, grid: IsochroneGrid) -> None:
    np.savez_compressed(
        path,
        feh=np.asarray(grid.feh),
        y=np.asarray(grid.y),
        age=np.asarray(grid.age),
        mass=np.asarray(grid.mass),
        mags=np.asarray(grid.mags),
        valid=np.asarray(grid.valid),
        agb_tip=np.asarray(grid.agb_tip),
        bands=np.asarray(grid.bands),
    )


def load_wd_cooling(settings: Settings) -> wdc.WdCoolingGrid:
    family = settings.models.wdModel.lower()
    if family not in WD_FAMILIES:
        raise ValueError(f"unknown wdModel {family}; one of {WD_FAMILIES}")
    path = _npz_path(settings.files.modelDirectory, f"wd_{family}")
    if path:
        import jax.numpy as jnp

        z = np.load(path)
        return wdc.pack(
            z["carb"], z["mass"], z["log_age"], z["log_teff"],
            z["log_radius"], name=family,
        )
    # Montgomery is the carbonicity-resolved family [SURVEY.md C6].
    return wdc.synthetic_wd_cooling(
        with_carbonicity=(family in ("montgomery", "synthetic")),
        name=f"synthetic-{family}",
    )


def load_wd_atmosphere(settings: Settings) -> wda.WdAtmosphereGrid:
    path = _npz_path(settings.files.modelDirectory, "bergeron")
    if path:
        import jax.numpy as jnp

        z = np.load(path, allow_pickle=False)
        return wda.WdAtmosphereGrid(
            log_teff=jnp.asarray(z["log_teff"]),
            log_g=jnp.asarray(z["log_g"]),
            mags=jnp.asarray(z["mags"]),
            bands=tuple(str(b) for b in z["bands"]),
            name="bergeron",
        )
    return wda.synthetic_bergeron(bands=tuple(settings.models.bands))


def make_model(settings: Settings) -> ModelBundle:
    """Resolve every model family from Settings (makeModel analog)."""
    return ModelBundle(
        ms=load_ms_grid(settings),
        wd_cooling=load_wd_cooling(settings),
        wd_atm=load_wd_atmosphere(settings),
        ifmr_kind=settings.models.ifmr,
    )
