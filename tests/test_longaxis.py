"""CI-scale rehearsal of the pod-scale (BASELINE config 5) recipe:
VI-initialized sharded HMC on the 8-device mesh (chains x stars), the
pipeline the 10k-star configuration runs on four GPUs (ROADMAP.md,
item 2.2).  Star count is CI-sized; the code path is identical:
full-rank ADVI -> covariance warm-starts the sharded warmup metric
(inv_mass0) -> chains start from VI draws -> converged chains."""
import jax
import jax.numpy as jnp
import numpy as np

from base_tpu.inference import diagnostics as diag
from base_tpu.inference.hmc import HMCConfig
from base_tpu.inference.vi import (
    VIConfig, posterior_covariance, run_vi, sample_posterior,
)
from base_tpu.model import posterior as post
from base_tpu.model.stardata import make_ms_stars
from base_tpu.parallel import run as prun
from base_tpu.parallel.mesh import make_mesh
from base_tpu.sim.scatter import scatter_cluster
from base_tpu.sim.simulate import simulate_cluster

TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0, 0, 0], np.float32)


def test_vi_initialized_sharded_hmc_converges(small_grid):
    S = 384
    cat = simulate_cluster(small_grid, jnp.asarray(TRUTH), S,
                           jax.random.PRNGKey(0), percent_binary=0.3)
    sc = scatter_cluster(cat.mags, jax.random.PRNGKey(1), limit_mag=24.0)
    stars = make_ms_stars(np.asarray(sc.mags), np.asarray(sc.sigmas),
                          cm_prior=0.99)
    model = post.make_single_pop_model(
        small_grid, stars, prior_mean=TRUTH,
        prior_sigma=np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1],
                             np.float32), n_q=4, upsample=4)
    tr = post.default_transform(model)
    fz = post.make_logpost_z_fn(model, tr)
    z0 = tr.inverse(jnp.asarray(TRUTH))
    free = np.asarray(post.free_mask(model), np.float32)

    # Stage 1: full-rank VI finds the (tight) posterior.
    vcfg = VIConfig(n_steps=400, n_mc=8, full_rank=True, init_log_sd=-3.0)
    res = jax.jit(lambda k: run_vi(fz, z0, k, vcfg))(jax.random.PRNGKey(5))
    assert np.isfinite(float(res.final_elbo))

    cov = np.asarray(posterior_covariance(res))
    cov = cov * (free[:, None] * free[None, :]) + np.diag(1.0 - free)

    # Stage 2: sharded HMC from VI draws under the VI metric.
    mesh = make_mesh(n_chain_shards=4, n_star_shards=2)
    C = 8
    init = sample_posterior(res, jax.random.PRNGKey(6), C)
    cfg = HMCConfig(n_warmup=96, n_samples=128, l_max=12, n_windows=3,
                    dense_mass=True, free_mask=tuple(free),
                    jitter_mode="step", init_step=0.1)
    zs, info = prun.run_hmc_sharded(
        model, tr, init, jax.random.PRNGKey(7), cfg, mesh,
        inv_mass0=jnp.asarray(cov),
    )
    assert zs.shape == (128, C, 9)
    xs = np.asarray(jax.vmap(jax.vmap(tr.forward))(zs))
    assert np.isfinite(xs).all()
    assert float(info["accept_prob"]) > 0.5
    rhat = np.asarray(diag.split_rhat(jnp.asarray(xs[:, :, :5])))
    # Converged at CI budget: every live parameter mixes.
    assert rhat.max() < 1.05, rhat
    # Truth recovery at <= 2 sd: upsample=4 (the production default)
    # puts the quadrature bias below the 384-star statistical error
    # (benchmarks/bias_study.out h^2 decay), so the posterior must
    # cover the truth within ordinary Monte-Carlo error.
    age = xs[:, :, 0]
    assert abs(age.mean() - TRUTH[0]) < max(2 * age.std(), 0.01)
