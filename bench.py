"""Headline benchmark: effective samples/sec (cluster age), NGC 188-scale.

Runs the BASELINE.json config-1 scenario (simCluster-style simulated
cluster, ~100 stars, fixed membership) end to end on one GPU, and
refuses to run without one: many HMC chains vmapped on the device, ESS
computed from the recorded age samples, divided by the end-to-end
(warmup + sampling) wall time.

Sampler config: dense mass matrix (the age-FeH-modulus degeneracy ridge
defeats a diagonal metric), l_max 48 (trajectory displacement ~
posterior scale), carbonicity/IFMR dims pinned (flat in an MS-only run
— the reference pins them with zero step sizes too), 64 chains.

`vs_baseline` divides by the MEASURED proxy floor in
BASELINE_MEASURED.json when present (reference-parity 1-chain adaptive
MH on CPU, produced by bench_baseline.py — base-cpp itself is not
buildable offline, SURVEY.md §7 step 0), else by the documented
working assumption of 5 effective samples/sec from the BASE-9 manual's
hours-scale runs.  The JSON `detail.baseline` says which was used.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ASSUMED_REFERENCE_ESS_PER_SEC = 5.0


def _baseline_floor():
    """Conservative divisor: the LARGER of the measured CPU-MH proxy and
    the documented 5 ESS/s assumption, so a weak proxy run can never
    inflate vs_baseline."""
    p = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "BASELINE_MEASURED.json")
    measured = None
    try:
        with open(p) as f:
            measured = float(json.load(f)["ess_per_sec"])
    except (OSError, KeyError, ValueError, TypeError):
        pass
    if measured is not None and measured > ASSUMED_REFERENCE_ESS_PER_SEC:
        return measured, "measured MH proxy (CPU, 1 chain)"
    label = "assumed 5 ESS/s (BASE-9 manual)"
    if measured is not None:
        label += f"; measured proxy {measured} ESS/s is lower"
    return ASSUMED_REFERENCE_ESS_PER_SEC, label


def main(smoke: bool = False):
    import jax
    import jax.numpy as jnp

    from base_tpu import platform

    device = platform.require_gpu()
    platform.setup_compile_cache()

    from base_tpu.inference import diagnostics as diag
    from base_tpu.inference.driver import make_hmc_chunked_runner
    from base_tpu.inference.hmc import HMCConfig
    from base_tpu.grids import synthetic
    from base_tpu.model import posterior as post
    from base_tpu.model.stardata import make_ms_stars
    from base_tpu.sim.scatter import scatter_cluster
    from base_tpu.sim.simulate import simulate_cluster

    truth = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0, 0, 0], np.float32)
    n_eep = 64
    grid = synthetic.make_grid(n_eep=n_eep)
    n_stars = 16 if smoke else 100
    n_chains = 4 if smoke else 64
    n_q = 8
    cfg = HMCConfig(
        n_warmup=8 if smoke else 256,
        n_samples=8 if smoke else 1024,
        l_max=4 if smoke else 48,
        n_windows=2 if smoke else 4,
        dense_mass=True,
        free_mask=(1, 1, 1, 1, 1, 0, 0, 0, 0),
        # Fixed-length trajectories + step-size jitter: every computed
        # leapfrog is used (length jitter discards ~25% on average) and
        # the full 48-step displacement makes draws near-IID.
        jitter_mode="step",
    )

    cat = simulate_cluster(grid, jnp.asarray(truth), n_stars,
                           jax.random.PRNGKey(0), percent_binary=0.3)
    sc = scatter_cluster(cat.mags, jax.random.PRNGKey(1), limit_mag=24.0)
    stars = make_ms_stars(np.asarray(sc.mags), np.asarray(sc.sigmas),
                          cm_prior=0.99)
    model = post.make_single_pop_model(
        grid, stars,
        prior_mean=truth,
        prior_sigma=np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1],
                             np.float32),
        n_q=n_q,
    )
    tr = post.default_transform(model)
    fz = post.make_logpost_z_fn(model, tr)
    z0 = tr.inverse(jnp.asarray(truth))
    init = jnp.tile(z0[None, :], (n_chains, 1))
    init = init + 0.02 * jax.random.normal(jax.random.PRNGKey(2), init.shape)

    # Host-chunked executions, as the CLI runs them (inference.driver).
    chunk_draws = 8 if smoke else 256
    runner = make_hmc_chunked_runner(fz, cfg, chunk_draws=chunk_draws)

    # Warm the compile cache with a 1-chunk run (the window and chunk
    # programs are shared with the full run), then time a fresh full
    # run end to end.
    zs, info = runner(init, jax.random.PRNGKey(3), n_samples=chunk_draws)
    jax.block_until_ready(zs)
    t0 = time.perf_counter()
    zs, info = runner(init, jax.random.PRNGKey(4))
    jax.block_until_ready(zs)
    dt = time.perf_counter() - t0

    xs = jax.vmap(jax.vmap(tr.forward))(zs)
    ess_age = float(diag.ess(xs[:, :, :1])[0])
    rhat_age = float(diag.split_rhat(xs[:, :, :1])[0])
    value = ess_age / dt
    floor, floor_label = _baseline_floor()
    n_draws = cfg.n_samples * n_chains
    n_leapfrog_evals = (cfg.n_warmup + cfg.n_samples) * cfg.l_max * n_chains
    # FLOP estimate for the dominant per-(star, segment) marginal work
    # (alpha/beta/gamma band contraction + transcendental tail), fwd+VJP.
    T = (n_eep - 1) * n_q
    flops_per_eval = n_stars * T * (8 * 8 + 50) * 3.0
    result = {
        "metric": "effective samples/sec (cluster age), NGC188-scale, 1 chip",
        "value": round(value, 2),
        "unit": "ESS/s",
        "vs_baseline": round(value / floor, 2),
        "detail": {
            "ess_age": round(ess_age, 1),
            "ess_per_draw": round(ess_age / n_draws, 4),
            "rhat_age": round(rhat_age, 4),
            "wall_s": round(dt, 3),
            "accept": round(float(info["accept_prob"]), 3),
            "step_size": round(float(info["step_size"]), 4),
            "logpost_grad_evals_per_sec": round(n_leapfrog_evals / dt, 1),
            "est_tflops": round(
                n_leapfrog_evals * flops_per_eval / dt / 1e12, 3),
            "chains": n_chains,
            "stars": n_stars,
            "sampler": "hmc dense-metric l_max=48 step-jitter",

            "baseline": floor_label,
            "baseline_ess_per_sec": floor,
            "device": device,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main(smoke="--smoke" in sys.argv)
