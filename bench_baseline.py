"""Measured baseline proxy: reference-parity adaptive MH, 1 chain, CPU.

VERDICT r1 #8 / SURVEY.md §7 step 0: base-cpp itself cannot be built
offline (the reference mount is a redirect README), so `vs_baseline`
must not stay a hard-coded constant.  This harness runs THIS repo's
reference-parity 3-stage adaptive MH [upstream: singlePopMcmc/MpiMcmcApplication.cpp
run() loop] single-chain on the CPU backend at the BASELINE.json
config-1 scenario (~100 stars, binaries, fixed membership) and records
effective-samples/sec for cluster age — a *proxy floor* for the C++
implementation (same algorithm, same arithmetic work per proposal; the
C++ would differ only by constant factors in its interpolation loop).

Writes BASELINE_MEASURED.json; bench.py divides by this when present,
falling back to the documented 5 ESS/s assumption otherwise.  Label is
carried through so BENCH JSON always says which floor was used.

Run:  python -u bench_baseline.py            (config 1, ~minutes on CPU)
      python -u bench_baseline.py --all      (+ proxies for configs 2-4)
      python -u bench_baseline.py --smoke    (tiny shapes, CI)

`--all` (VERDICT r3 #10) adds measured single-chain adaptive-MH proxy
floors for the other acceptance scenarios: config 2 (binaries +
field-star contamination), config 3 (WD population + tunable IFMR) and
config 4 (two-population multiPop) — so every BASELINE scenario has a
measured floor, not just config 1.  Results land under "configs" in
BASELINE_MEASURED.json; bench.py keeps using the top-level config-1
floor.
"""
from __future__ import annotations

import json
import sys
import time


def _measure_mh(logpost, p0, step_init, cfg, ess_param: int = 0):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from base_tpu.inference import diagnostics as diag
    from base_tpu.inference import mh

    runner = jax.jit(
        lambda p, k: mh.run_adaptive_mh(
            logpost, p, k, jnp.asarray(step_init), cfg))
    samples, info = runner(p0, jax.random.PRNGKey(5))   # compile
    jax.block_until_ready(samples)
    t0 = time.perf_counter()
    samples, info = runner(p0, jax.random.PRNGKey(6))
    jax.block_until_ready(samples)
    dt = time.perf_counter() - t0
    ess = float(diag.ess(samples[:, None, ess_param:ess_param + 1])[0])
    return dict(
        ess_per_sec=round(ess / dt, 3), ess=round(ess, 1),
        wall_s=round(dt, 3),
        accept=round(float(np.asarray(info["accept_rate"])), 3),
    )


def main(smoke: bool = False):
    import jax

    # The baseline is a CPU measurement: pin the CPU before any jax use.
    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from base_tpu.inference import diagnostics as diag
    from base_tpu.inference import mh
    from base_tpu.grids import synthetic
    from base_tpu.model import posterior as post
    from base_tpu.model.stardata import make_ms_stars
    from base_tpu.sim.scatter import scatter_cluster
    from base_tpu.sim.simulate import simulate_cluster

    truth = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0, 0, 0], np.float32)
    grid = synthetic.make_grid(n_eep=64)
    n_stars = 16 if smoke else 100
    cfg = mh.MHConfig(
        n_stage1=50 if smoke else 1000,
        n_stage2=50 if smoke else 1000,
        n_main=100 if smoke else 5000,
    )

    cat = simulate_cluster(grid, jnp.asarray(truth), n_stars,
                           jax.random.PRNGKey(0), percent_binary=0.3)
    sc = scatter_cluster(cat.mags, jax.random.PRNGKey(1), limit_mag=24.0)
    stars = make_ms_stars(np.asarray(sc.mags), np.asarray(sc.sigmas),
                          cm_prior=0.99)
    model = post.make_single_pop_model(
        grid, stars, prior_mean=truth,
        prior_sigma=np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1],
                             np.float32),
        n_q=8,
    )
    logpost = post.make_logpost_fn(model)
    step_init = np.array(
        [0.02, 0.002, 0.005, 0.005, 0.002, 0, 0, 0, 0], np.float32)

    runner = jax.jit(
        lambda p0, k: mh.run_adaptive_mh(
            logpost, p0, k, jnp.asarray(step_init), cfg))
    p0 = jnp.asarray(truth)
    samples, info = runner(p0, jax.random.PRNGKey(5))   # compile
    jax.block_until_ready(samples)
    t0 = time.perf_counter()
    samples, info = runner(p0, jax.random.PRNGKey(6))
    jax.block_until_ready(samples)
    dt = time.perf_counter() - t0

    ess_age = float(diag.ess(samples[:, None, :1])[0])
    result = {
        "label": "measured proxy: 1-chain adaptive MH on CPU "
                 "(reference-parity algorithm; base-cpp unbuildable offline)",
        "ess_per_sec": round(ess_age / dt, 3),
        "ess_age": round(ess_age, 1),
        "wall_s": round(dt, 3),
        "n_main": cfg.n_main,
        "stars": n_stars,
        "accept": round(float(info["accept_rate"]), 3),
        "smoke": smoke,
    }
    print(json.dumps(result))
    if "--all" in sys.argv:
        result["configs"] = _other_configs(smoke)
        print(json.dumps({"configs": result["configs"]}))
    if not smoke:
        with open("BASELINE_MEASURED.json", "w") as f:
            json.dump(result, f, indent=1)


def _other_configs(smoke: bool) -> dict:
    """Measured MH proxy floors for BASELINE configs 2-4."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from base_tpu.inference import mh
    from base_tpu.grids import synthetic
    from base_tpu.grids.wd_atmosphere import synthetic_bergeron
    from base_tpu.grids.wd_cooling import synthetic_wd_cooling
    from base_tpu.model import multipop as mp
    from base_tpu.model import posterior as post
    from base_tpu.model.stardata import make_ms_stars
    from base_tpu.sim.scatter import scatter_cluster
    from base_tpu.sim.simulate import simulate_cluster

    truth = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0.7, 0.08, 0.0],
                     np.float32)
    grid = synthetic.make_grid(n_eep=32 if smoke else 64)
    n = 16 if smoke else 100
    cfg = mh.MHConfig(
        n_stage1=50 if smoke else 1000,
        n_stage2=50 if smoke else 1000,
        n_main=100 if smoke else 5000,
    )
    out = {}

    # --- config 2: binaries + field-star contamination ---------------
    from base_tpu.sim.simulate import simulate_field_stars

    cat = simulate_cluster(grid, jnp.asarray(truth), n,
                           jax.random.PRNGKey(10), percent_binary=0.5)
    n_field = max(n // 10, 2)
    fmags = simulate_field_stars(jax.random.PRNGKey(11), n_field, cat.mags)
    mags = jnp.concatenate([cat.mags, fmags])
    sc = scatter_cluster(mags, jax.random.PRNGKey(12), limit_mag=24.0)
    cm = np.concatenate([np.full(n, 0.95, np.float32),
                         np.full(n_field, 0.5, np.float32)])
    stars = make_ms_stars(np.asarray(sc.mags), np.asarray(sc.sigmas),
                          cm_prior=cm)
    m2 = post.make_single_pop_model(
        grid, stars, prior_mean=truth,
        prior_sigma=np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1],
                             np.float32), n_q=8)
    step = np.array([0.02, 0.002, 0.005, 0.005, 0.002, 0, 0, 0, 0],
                    np.float32)
    out["config2_binaries_field"] = _measure_mh(
        post.make_logpost_fn(m2), jnp.asarray(truth), step, cfg)

    # --- config 3: WD population + tunable linear IFMR ---------------
    wdc, wda = synthetic_wd_cooling(), synthetic_bergeron()
    cat3 = simulate_cluster(grid, jnp.asarray(truth), 4 * n,
                            jax.random.PRNGKey(13), percent_binary=0.3,
                            wd_cooling=wdc, wd_atm=wda,
                            ifmr_kind="linear", percent_db=0.1)
    sc3 = scatter_cluster(cat3.mags, jax.random.PRNGKey(14),
                          limit_mag=24.0)
    st3 = np.asarray(cat3.stage)
    is_wd = st3 == 3
    mg, sg = np.asarray(sc3.mags), np.asarray(sc3.sigmas)
    m3 = post.make_single_pop_model(
        grid, make_ms_stars(mg[~is_wd], sg[~is_wd], cm_prior=0.99),
        prior_mean=truth,
        prior_sigma=np.array([-1, -1, 0.3, 0.2, 0.1, -1, 0.3, 0.15, -1],
                             np.float32),
        n_q=8, wd_cooling=wdc, wd_atm=wda,
        wd_stars=make_ms_stars(mg[is_wd], sg[is_wd], cm_prior=0.99),
        ifmr_kind="linear", p_db=0.1,
    )
    step3 = np.array(
        [0.02, 0.002, 0.005, 0.005, 0.002, 0.02, 0.02, 0.01, 0],
        np.float32)
    out["config3_wd_ifmr"] = _measure_mh(
        post.make_logpost_fn(m3), jnp.asarray(truth), step3, cfg,
        ess_param=7)

    # --- config 4: two-population multiPop ---------------------------
    ya, yb, lam = 0.25, 0.30, 0.6
    ta = truth.copy(); ta[1] = ya
    tb = truth.copy(); tb[1] = yb
    na = int(round(n * lam))
    ca = simulate_cluster(grid, jnp.asarray(ta), na,
                          jax.random.PRNGKey(15), percent_binary=0.3)
    cb = simulate_cluster(grid, jnp.asarray(tb), n - na,
                          jax.random.PRNGKey(16), percent_binary=0.3)
    sc4 = scatter_cluster(jnp.concatenate([ca.mags, cb.mags]),
                          jax.random.PRNGKey(17), limit_mag=24.0)
    stars4 = make_ms_stars(np.asarray(sc4.mags), np.asarray(sc4.sigmas),
                           cm_prior=0.99)
    pm = np.concatenate([truth, [ya, yb, 0.5]]).astype(np.float32)
    ps = np.concatenate(
        [np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1], np.float32),
         [-1, -1, -1]]).astype(np.float32)
    m4 = mp.make_multipop_model(grid, stars4, pm, ps, n_q=8)
    step4 = np.zeros(12, np.float32)
    step4[[0, 2, 3, 4]] = [0.02, 0.005, 0.005, 0.002]
    step4[[mp.MP_YYA, mp.MP_YYB, mp.MP_LAMBDA]] = [0.002, 0.002, 0.02]
    start4 = np.concatenate([truth, [ya, yb, lam]]).astype(np.float32)
    out["config4_multipop"] = _measure_mh(
        mp.make_logpost_fn(m4), jnp.asarray(start4), step4, cfg,
        ess_param=mp.MP_YYA)
    return out


if __name__ == "__main__":
    main(smoke="--smoke" in sys.argv)
