"""WD branch tests: cooling/atmosphere interpolation vs scipy, IFMR
forms, precursor-lifetime inversion, and WD-inclusive posterior sanity
(SURVEY.md §4.2; BASELINE config 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from base_tpu import constants as C
from base_tpu.grids.wd_atmosphere import synthetic_bergeron, wd_mags
from base_tpu.grids.wd_cooling import synthetic_wd_cooling, wd_teff_radius
from base_tpu.model import ifmr as ifmr_mod
from base_tpu.model import posterior as post
from base_tpu.model import wd as wd_mod
from base_tpu.model.stardata import make_ms_stars
from base_tpu.sim.scatter import scatter_cluster
from base_tpu.sim.simulate import simulate_cluster

TRUTH = np.array(
    [9.5, 0.27, -0.3, 8.0, 0.15, 0.5, 0.721, 0.109, 0.0], np.float32
)


def test_cooling_interp_matches_scipy(rng):
    from scipy.interpolate import RegularGridInterpolator

    g = synthetic_wd_cooling()
    interp = RegularGridInterpolator(
        (np.asarray(g.carb), np.asarray(g.mass), np.asarray(g.log_age)),
        np.asarray(g.log_teff),
    )
    pts = np.stack([
        rng.uniform(0.05, 0.95, 50),
        rng.uniform(0.45, 1.15, 50),
        rng.uniform(5.2, 10.0, 50),
    ], -1).astype(np.float32)
    want = interp(pts)
    got = np.asarray(jax.vmap(
        lambda p: wd_teff_radius(g, p[0], p[1], p[2])[0]
    )(jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cooling_len1_carb_axis():
    g = synthetic_wd_cooling(with_carbonicity=False)
    lt, lr, ok = wd_teff_radius(g, 0.77, 0.6, 8.0)  # any carb accepted
    assert np.isfinite(float(lt)) and np.isfinite(float(lr)) and bool(ok)


def test_atmosphere_physics():
    g = synthetic_bergeron()
    hot, _ = wd_mags(g, 4.3, 8.0, 0)
    cool, _ = wd_mags(g, 3.6, 8.0, 0)
    assert float(hot[2]) < float(cool[2])  # hotter -> brighter in V
    da, _ = wd_mags(g, 4.0, 8.0, 0)
    db, _ = wd_mags(g, 4.0, 8.0, 1)
    assert not np.allclose(np.asarray(da), np.asarray(db))


def test_ifmr_forms():
    p = jnp.asarray(TRUTH)
    m = jnp.asarray([1.0, 3.0, 5.0, 7.0])
    for kind in ifmr_mod.FIXED_IFMRS + ifmr_mod.TUNABLE_IFMRS:
        w = np.asarray(ifmr_mod.ifmr_mass(kind, m, p))
        assert np.all(w > 0.2) and np.all(w < 1.5), (kind, w)
        assert np.all(np.diff(w) > 0), (kind, w)  # monotone increasing
    # tunable linear at the pivot = intercept
    at_pivot = float(ifmr_mod.ifmr_mass(
        "linear", jnp.asarray(ifmr_mod.IFMR_PIVOT), p
    ))
    np.testing.assert_allclose(at_pivot, TRUTH[6], rtol=1e-6)


def test_prec_logage_inversion(small_grid):
    """Heavier stars live shorter; inverting tip(age) must reproduce the
    grid's own AGB-tip masses."""
    mz = jnp.asarray([1.2, 2.0, 3.5])
    prec = np.asarray(wd_mod.wd_prec_logage(small_grid, -0.5, 0.27, mz))
    assert np.all(np.diff(prec) < 0)
    # Round-trip: the AGB tip at age prec(m) should be ~m.
    from base_tpu.grids.isochrone import derive_isochrone

    for m, a in zip(np.asarray(mz), prec):
        if small_grid.age[0] < a < small_grid.age[-1]:
            iso = derive_isochrone(small_grid, -0.5, 0.27, float(a))
            np.testing.assert_allclose(float(iso.agb_tip), m, rtol=0.05)


@pytest.fixture(scope="module")
def wd_dataset(small_grid):
    cooling = synthetic_wd_cooling()
    atm = synthetic_bergeron()
    cat = simulate_cluster(
        small_grid, jnp.asarray(TRUTH), 80, jax.random.PRNGKey(31),
        percent_binary=0.0, wd_cooling=cooling, wd_atm=atm,
        ifmr_kind="linear", percent_db=0.15,
    )
    sc = scatter_cluster(cat.mags, jax.random.PRNGKey(32), limit_mag=26.0)
    stage = np.asarray(cat.stage)
    mags = np.asarray(sc.mags)
    sig = np.asarray(sc.sigmas)
    is_wd = stage == C.StarStatus.WD
    assert is_wd.sum() >= 3, f"want WDs in the sim, got {is_wd.sum()}"
    ms = make_ms_stars(mags[~is_wd], sig[~is_wd], cm_prior=0.999)
    wds = make_ms_stars(mags[is_wd], sig[is_wd], cm_prior=0.999)
    model = post.make_single_pop_model(
        small_grid, ms,
        prior_mean=TRUTH,
        prior_sigma=np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1],
                             np.float32),
        n_q=6, binaries=False,
        wd_cooling=cooling, wd_atm=atm, wd_stars=wds,
        ifmr_kind="linear", p_db=0.15,
    )
    return model


def test_wd_logpost_finite_and_informative(wd_dataset):
    model = wd_dataset
    f = jax.jit(post.make_logpost_fn(model))
    at_truth = float(f(jnp.asarray(TRUTH)))
    assert np.isfinite(at_truth)
    off = TRUTH.copy()
    off[C.Param.AGE] = 8.8
    assert float(f(jnp.asarray(off))) < at_truth - 10.0


def test_wd_logpost_gradient_finite(wd_dataset):
    model = wd_dataset
    tr = post.default_transform(model)
    fz = jax.jit(post.make_logpost_z_fn(model, tr))
    z0 = tr.inverse(jnp.asarray(TRUTH))
    g = np.asarray(jax.grad(fz)(z0))
    assert np.isfinite(g).all()
    # IFMR intercept/slope must now receive gradient signal from the WDs.
    assert abs(g[C.Param.IFMR_INTERCEPT]) > 0


def test_wd_ifmr_sensitivity(wd_dataset):
    """Shifting the tunable IFMR intercept must change the WD likelihood
    (the sampleWDMass/IFMR science case, BASELINE.json:9)."""
    model = wd_dataset
    f = jax.jit(post.make_logpost_fn(model))
    base = float(f(jnp.asarray(TRUTH)))
    shifted = TRUTH.copy()
    shifted[C.Param.IFMR_INTERCEPT] += 0.15
    assert abs(float(f(jnp.asarray(shifted))) - base) > 1.0


def test_wd_segment_integral_matches_dense_nodal(wd_dataset):
    """The segment-exact WD precursor-mass integral at production K must
    match the nodal quadrature in its converged limit (K -> large), and
    expose the coarse nodal form's aliasing (r4 config-3 diagnosis: the
    nodal sum wiggles by nats as theta moves, trapping chains)."""
    model = wd_dataset
    p = jnp.asarray(TRUTH).at[6].set(0.721).at[7].set(0.109)
    mod, av = p[C.Param.MOD], p[C.Param.ABS]

    def marg(fn, K, **kw):
        mz = jnp.linspace(0.8, C.MAX_WD_PRECURSOR_MASS, K)
        mags, _, valid = wd_mod.wd_model_mags(
            model.grid, model.wd_cooling, model.wd_atm, p, mz, "linear"
        )
        return np.asarray(fn(
            model.wd_stars, mags, valid, mz, mod, av, model.abs_coefs,
            model.p_db, **kw
        ))

    seg96 = marg(wd_mod.wd_star_log_marginals, 96)
    seg192 = marg(wd_mod.wd_star_log_marginals, 192)
    nodal_dense = marg(wd_mod.wd_star_log_marginals_nodal, 4096)

    sel = nodal_dense > -200
    assert sel.sum() >= 3
    # segment form converges to the nodal limit as O(h^2) (the chord
    # slightly over-counts where mags(mz) is convex: ~0.1 nat at K=96,
    # ~0.03 at K=192 — a smooth theta-independent offset, unlike the
    # nodal form's theta-dependent aliasing wiggle)
    np.testing.assert_allclose(seg192[sel], nodal_dense[sel], atol=0.08)
    np.testing.assert_allclose(seg96[sel], seg192[sel], atol=0.15)


def test_wd_segment_pallas_parity(wd_dataset):
    """The WD marginal's concatenated DA+DB segment table through the
    fused kernel (interpreted on CPU; what a GPU runs) gives the jnp
    segment path's answer."""
    from base_tpu.model import likelihood as lk
    from base_tpu.ops.pallas_marglik import Tiles, fused_log_marginals

    model = wd_dataset
    p = jnp.asarray(TRUTH).at[6].set(0.721).at[7].set(0.109)
    mod, av = p[C.Param.MOD], p[C.Param.ABS]
    mz = jnp.linspace(0.8, C.MAX_WD_PRECURSOR_MASS, 96)
    mags, _, valid = wd_mod.wd_model_mags(
        model.grid, model.wd_cooling, model.wd_atm, p, mz, "linear"
    )
    table = wd_mod.wd_segment_table(
        mags, valid, mz, mod, av, model.abs_coefs, model.p_db)
    st = model.wd_stars
    a = np.asarray(lk.ms_star_log_marginals(st, table))
    b = np.asarray(fused_log_marginals(
        st.obs_mags, st.inv_var, st.log_norm, table.lo, table.hi,
        table.logw, table.mask.astype(jnp.float32), interpret=True,
        tiles=Tiles(s=8, t=32)))
    sel = a > -200
    np.testing.assert_allclose(b[sel], a[sel], atol=5e-2)
    # and the dispatching entry point is the jnp path on the CPU
    np.testing.assert_array_equal(
        np.asarray(wd_mod.wd_star_log_marginals(
            st, mags, valid, mz, mod, av, model.abs_coefs, model.p_db)),
        np.maximum(a, -1e30))
