"""Sampler correctness: exact-moment checks on a known Gaussian target
(SURVEY.md §4.2.3a) and round-trip truth recovery on the toy cluster model
(§4.2.3c, the simCluster -> scatter -> singlePop workflow of BASELINE
config 1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from base_tpu.inference import hmc, mh
from base_tpu.model import posterior as post
from base_tpu.model.stardata import make_ms_stars
from base_tpu.sim.scatter import scatter_cluster
from base_tpu.sim.simulate import simulate_cluster

TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0.0, 0.0, 0.0], np.float32)

# Correlated 2-D Gaussian target with known moments.
COV = np.array([[1.0, 0.7], [0.7, 2.0]], np.float32)
MEAN = np.array([1.0, -2.0], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)


def gauss_logpost(x):
    d = x - jnp.asarray(MEAN)
    return -0.5 * d @ jnp.asarray(PREC) @ d


def test_mh_gaussian_moments():
    cfg = mh.MHConfig(n_stage1=500, n_stage2=500, n_main=4000)
    samples, info = jax.vmap(
        lambda k: mh.run_adaptive_mh(
            gauss_logpost, jnp.zeros(2), k, jnp.ones(2) * 0.5, cfg
        )
    )(jax.random.split(jax.random.PRNGKey(0), 8))
    flat = np.asarray(samples).reshape(-1, 2)
    rate = float(np.mean(np.asarray(info["accept_rate"])))
    assert 0.1 < rate < 0.7
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.4)


def test_mh_pinned_params_never_move():
    step = jnp.asarray([0.5, 0.0], jnp.float32)  # pin dim 1
    cfg = mh.MHConfig(n_stage1=200, n_stage2=200, n_main=500)
    samples, _ = mh.run_adaptive_mh(
        gauss_logpost, jnp.asarray([0.0, 3.5]), jax.random.PRNGKey(3), step, cfg
    )
    s = np.asarray(samples)
    assert np.all(s[:, 1] == 3.5)
    assert np.std(s[:, 0]) > 0.1


def test_hmc_gaussian_moments():
    cfg = hmc.HMCConfig(n_warmup=400, n_samples=500, l_max=16)
    init = jax.random.normal(jax.random.PRNGKey(1), (8, 2))
    samples, info = jax.jit(
        lambda z, k: hmc.run_hmc(gauss_logpost, z, k, cfg)
    )(init, jax.random.PRNGKey(2))
    flat = np.asarray(samples).reshape(-1, 2)
    assert float(info["accept_prob"]) > 0.5
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.4)
    # Mass adaptation should have learned the scale ordering.
    im = np.asarray(info["inv_mass"])
    assert im[1] > im[0]


def test_hmc_chunked_runner_bit_identical():
    """The host-chunked runner (per-window + per-chunk device
    executions, the production path) must be bit-identical
    to the monolithic run_hmc — same RNG stream, same updates."""
    from base_tpu.inference.driver import make_hmc_chunked_runner

    cfg = hmc.HMCConfig(n_warmup=90, n_samples=60, l_max=6, n_windows=3,
                        dense_mass=True)
    init = 0.3 * jax.random.normal(jax.random.PRNGKey(3), (6, 2))
    key = jax.random.PRNGKey(4)
    zs_mono, info_mono = jax.jit(
        lambda z, k: hmc.run_hmc(gauss_logpost, z, k, cfg)
    )(init, key)
    zs_chunk, info_chunk = make_hmc_chunked_runner(
        gauss_logpost, cfg, chunk_draws=25  # uneven chunking on purpose
    )(init, key)
    np.testing.assert_array_equal(np.asarray(zs_mono),
                                  np.asarray(zs_chunk))
    np.testing.assert_array_equal(np.asarray(info_mono["inv_mass"]),
                                  np.asarray(info_chunk["inv_mass"]))
    assert float(info_mono["step_size"]) == float(info_chunk["step_size"])


def test_hmc_step_jitter_gaussian_moments():
    """jitter_mode='step' (fixed length, eps ~ U(0.8, 1.2) x eps) is a
    valid kernel: exact moments on the correlated Gaussian.  This is the
    bench's throughput mode (every computed leapfrog used)."""
    cfg = hmc.HMCConfig(n_warmup=400, n_samples=500, l_max=16,
                        jitter_mode="step", dense_mass=True)
    init = jax.random.normal(jax.random.PRNGKey(7), (8, 2))
    samples, info = jax.jit(
        lambda z, k: hmc.run_hmc(gauss_logpost, z, k, cfg)
    )(init, jax.random.PRNGKey(8))
    flat = np.asarray(samples).reshape(-1, 2)
    assert float(info["accept_prob"]) > 0.6
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.4)


def test_hmc_dense_mass_correlated_gaussian():
    """Dense metric recovers a strongly correlated Gaussian's covariance."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 4)).astype(np.float32)
    cov = a @ a.T + 0.1 * np.eye(4, dtype=np.float32)
    icov = jnp.asarray(np.linalg.inv(cov))

    def logpost(z):
        return -0.5 * z @ icov @ z

    cfg = hmc.HMCConfig(
        n_warmup=400, n_samples=400, l_max=12, dense_mass=True
    )
    init = jax.random.normal(jax.random.PRNGKey(5), (8, 4))
    samples, info = jax.jit(
        lambda z, k: hmc.run_hmc(logpost, z, k, cfg)
    )(init, jax.random.PRNGKey(6))
    assert float(info["accept_prob"]) > 0.6
    im = np.asarray(info["inv_mass"])
    assert im.shape == (4, 4)
    emp = np.cov(np.asarray(samples).reshape(-1, 4).T)
    rel = np.abs(emp - cov).max() / np.abs(cov).max()
    assert rel < 0.25, rel
    # The adapted metric itself should approximate the target covariance.
    mrel = np.abs(im - cov).max() / np.abs(cov).max()
    assert mrel < 0.35, mrel


@pytest.fixture(scope="module")
def cluster_model(small_grid):
    cat = simulate_cluster(
        small_grid, jnp.asarray(TRUTH), 48, jax.random.PRNGKey(11),
        percent_binary=0.0,
    )
    sc = scatter_cluster(cat.mags, jax.random.PRNGKey(12), limit_mag=24.0)
    stars = make_ms_stars(
        np.asarray(sc.mags), np.asarray(sc.sigmas), cm_prior=0.999,
    )
    return post.make_single_pop_model(
        small_grid, stars,
        prior_mean=TRUTH,
        prior_sigma=np.array(
            [-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1], np.float32
        ),
        n_q=6, binaries=False,
    )


def test_mh_truth_recovery(cluster_model):
    """Reference-parity mode: adaptive MH recovers simulation truth
    (the de-facto validation workflow of the reference, SURVEY.md §4.1)."""
    f = post.make_logpost_fn(cluster_model)
    step0 = jnp.asarray(
        [0.05, 0.02, 0.05, 0.05, 0.03, 0, 0, 0, 0], jnp.float32
    )
    cfg = mh.MHConfig(n_stage1=400, n_stage2=400, n_main=1200)
    samples, info = jax.jit(
        lambda k: mh.run_adaptive_mh(f, jnp.asarray(TRUTH), k, step0, cfg)
    )(jax.random.PRNGKey(4))
    s = np.asarray(samples)
    assert np.isfinite(np.asarray(info["logposts"])).all()
    for p, tol in [(0, 0.1), (2, 0.3), (3, 0.3), (4, 0.2)]:
        est = s[:, p].mean()
        sd = s[:, p].std() + 1e-4
        assert abs(est - TRUTH[p]) < max(4 * sd, tol), (p, est, sd)
    # IFMR params pinned
    assert np.all(s[:, 6:] == 0.0)


def test_hmc_truth_recovery(cluster_model):
    tr = post.default_transform(cluster_model)
    fz = post.make_logpost_z_fn(cluster_model, tr)
    z0 = tr.inverse(jnp.asarray(TRUTH))
    init = jnp.tile(z0[None, :], (4, 1))
    init = init + 0.01 * jax.random.normal(jax.random.PRNGKey(5), init.shape)
    cfg = hmc.HMCConfig(n_warmup=200, n_samples=150, l_max=12)
    zs, info = jax.jit(
        lambda z, k: hmc.run_hmc(fz, z, k, cfg)
    )(init, jax.random.PRNGKey(6))
    xs = np.asarray(jax.vmap(jax.vmap(tr.forward))(zs)).reshape(-1, 9)
    assert float(info["accept_prob"]) > 0.4
    for p, tol in [(0, 0.1), (2, 0.35), (3, 0.35), (4, 0.25)]:
        est = xs[:, p].mean()
        sd = xs[:, p].std() + 1e-4
        assert abs(est - TRUTH[p]) < max(4 * sd, tol), (p, est, sd)


def test_pooled_cov_large_mean_small_std():
    """Regression (ADVICE r1 high): centered two-pass covariance must stay
    positive-definite for parameters with large mean and tiny posterior
    std (distMod ~ 10, sd ~ 2e-3 used to go indefinite via one-pass
    float32 cancellation, silently NaN-ing the Cholesky)."""
    key = jax.random.PRNGKey(0)
    n = 800
    mean = jnp.asarray([10.0, -0.5, 9.3], jnp.float32)
    sd = jnp.asarray([0.002, 0.001, 0.003], jnp.float32)
    zs = mean + sd * jax.random.normal(key, (n, 3))
    cov = hmc._pooled_cov(zs[:, None, :], None)
    eigs = np.linalg.eigvalsh(np.asarray(cov))
    assert np.all(eigs > 0), eigs
    chol = np.asarray(hmc._metric_chol(cov))
    assert np.all(np.isfinite(chol))
    # and the estimate is close to the true (co)variance, not ridge-dominated
    np.testing.assert_allclose(
        np.sqrt(np.diag(np.asarray(cov))), np.asarray(sd), rtol=0.25
    )
