"""CLI entry points mirroring the reference executables.

One `python -m base_tpu.tools.main <tool>` per reference binary
[upstream: singlePopMcmc/, simCluster/, scatterCluster/, sampleMass/,
sampleWDMass/, makeCMD/ — SURVEY.md E1-E7]:

  simulate        simCluster: forward-model a cluster, write photometry
  scatter         scatterCluster: add noise/cutoffs, write sampler .phot
  single-pop      singlePopMcmc: posterior over cluster params (HMC or
                  reference-parity adaptive MH), write .res
  sample-mass     sampleMass: per-star (mass, ratio) conditionals
  sample-wd-mass  sampleWDMass: per-WD precursor/WD-mass conditionals
  make-cmd        makeCMD: model isochrone CMD at given params

Every tool shares one YAML config (+ `--set a.b=c` overrides), like the
reference's single base9.yaml [SURVEY.md C12].
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from base_tpu import constants as C
from base_tpu.io import phot as photio
from base_tpu.io import res as resio
from base_tpu.io.settings import Settings, load_settings


def _common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", default=None, help="YAML settings file")
    parser.add_argument(
        "--set", action="append", default=[], metavar="a.b=c",
        help="dotted settings override (repeatable)",
    )
    parser.add_argument("--photFile", default=None)
    parser.add_argument("--outputFileBase", default=None)
    parser.add_argument("--modelDirectory", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="dump a jax.profiler (xplane) trace of the run to DIR",
    )
    parser.add_argument(
        "--metrics", default=None, metavar="FILE.jsonl",
        help="append structured throughput metrics to FILE.jsonl",
    )
    parser.add_argument(
        "--mesh", default=None, metavar="C,S",
        help="shard over a (chains x stars) device mesh, e.g. 4,2",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="checkpoint to <outputFileBase>.ckpt and resume if present "
             "(hmc sampler)",
    )
    parser.add_argument(
        "--store", default=None, choices=("file", "sqlite"),
        help="chain-output backing store (files.store): 'sqlite' also "
             "writes <outputFileBase>.db",
    )


def _settings(args) -> Settings:
    s = load_settings(args.config, args.set)
    if args.photFile is not None:
        s.files.photFile = args.photFile
    if args.outputFileBase is not None:
        s.files.outputFileBase = args.outputFileBase
    if args.modelDirectory is not None:
        s.files.modelDirectory = args.modelDirectory
    if args.seed is not None:
        s.mcmc.seed = args.seed
    if getattr(args, "store", None) is not None:
        s.files.store = args.store
    return s


def _truth_params(s: Settings) -> np.ndarray:
    return s.cluster.start_vector()


def cmd_simulate(args) -> None:
    import jax
    import jax.numpy as jnp

    from base_tpu.grids.load import make_model
    from base_tpu.sim.simulate import simulate_cluster

    s = _settings(args)
    bundle = make_model(s)
    params = _truth_params(s)
    cat = simulate_cluster(
        bundle.ms, jnp.asarray(params), s.simCluster.nStars,
        jax.random.PRNGKey(s.mcmc.seed),
        percent_binary=s.simCluster.percentBinary,
        min_mass=s.simCluster.minMass,
        wd_cooling=bundle.wd_cooling, wd_atm=bundle.wd_atm,
        ifmr_kind=bundle.ifmr_kind,
        percent_db=s.simCluster.percentDB,
    )
    mags = np.asarray(cat.mags)
    mass1 = np.asarray(cat.mass1)
    mratio = np.asarray(cat.mass_ratio)
    stage = np.asarray(cat.stage)
    cm = np.full(mags.shape[0], 0.999, np.float32)
    n_field = s.simCluster.nFieldStars
    if n_field > 0:
        from base_tpu.sim.simulate import simulate_field_stars

        fmags = np.asarray(simulate_field_stars(
            jax.random.PRNGKey(s.mcmc.seed + 7), n_field, cat.mags
        ))
        mags = np.concatenate([mags, fmags])
        mass1 = np.concatenate([mass1, np.ones(n_field, np.float32)])
        mratio = np.concatenate([mratio, np.zeros(n_field, np.float32)])
        stage = np.concatenate(
            [stage, np.full(n_field, C.StarStatus.MSRG, np.int32)]
        )
        cm = np.concatenate([cm, np.full(n_field, 0.01, np.float32)])
    table = photio.from_simulation(
        ids=None, bands=bundle.ms.bands,
        mags=mags,
        sigmas=np.zeros_like(mags),
        mass1=mass1,
        mass_ratio=mratio,
        stage=stage,
        cm_prior=cm,
    )
    out = s.files.outputFileBase + ".sim.phot"
    photio.write_phot(out, table)
    n_wd = int((stage == C.StarStatus.WD).sum())
    print(
        f"simulate: wrote {table.n_stars} stars ({n_wd} WDs, "
        f"{n_field} field) -> {out}"
    )


def cmd_scatter(args) -> None:
    import jax
    import jax.numpy as jnp

    from base_tpu.sim.scatter import exposure_limits, scatter_cluster

    s = _settings(args)
    table = photio.read_phot(s.files.photFile)
    if s.scatterCluster.exposures:
        limits = exposure_limits(
            [float(x) for x in s.scatterCluster.exposures],
            base_limit=s.scatterCluster.limitMag,
        )
    else:
        limits = s.scatterCluster.limitMag
    sc = scatter_cluster(
        jnp.asarray(table.mags), jax.random.PRNGKey(s.mcmc.seed + 1),
        limit_mag=limits,
        bright_limit=s.scatterCluster.brightLimit,
        faint_limit=s.scatterCluster.faintLimit,
        sigma_floor=s.scatterCluster.sigmaFloor,
        relevant_filt=s.scatterCluster.relevantFilt,
    )
    table.mags = np.asarray(sc.mags)
    table.sigmas = np.asarray(sc.sigmas)
    out = s.files.outputFileBase + ".phot"
    photio.write_phot(out, table)
    print(f"scatter: wrote {table.n_stars} stars -> {out}")


def _active_bands(table, ms_grid, wd_atm=None):
    """Dynamic filter selection: active set = .phot header ∩ model bands
    (∩ atmosphere bands when WDs are present) [upstream: base9/Filters —
    SURVEY.md C13].  Returns (phot table, ms grid, wd atm) all sliced to
    the active set; errors clearly on an empty intersection."""
    from base_tpu.grids import filters as filt
    from base_tpu.grids.isochrone import select_grid_bands
    from base_tpu.grids.wd_atmosphere import select_atm_bands

    active, phot_idx, ms_idx = filt.intersect_bands(table.bands, ms_grid.bands)
    if wd_atm is not None:
        active, sub_idx, atm_idx = filt.intersect_bands(active, wd_atm.bands)
        phot_idx, ms_idx = phot_idx[sub_idx], ms_idx[sub_idx]
    if not active:
        raise SystemExit(
            f"no overlapping filters: photometry has {list(table.bands)}, "
            f"model grid '{ms_grid.name}' has {list(ms_grid.bands)}"
            + (f", WD atmospheres have {list(wd_atm.bands)}" if wd_atm else "")
        )
    if tuple(active) != tuple(table.bands):
        table = table.select_bands(phot_idx, active)
    if tuple(active) != tuple(ms_grid.bands):
        ms_grid = select_grid_bands(ms_grid, ms_idx, active)
    if wd_atm is not None and tuple(active) != tuple(wd_atm.bands):
        wd_atm = select_atm_bands(wd_atm, atm_idx, active)
    return table, ms_grid, wd_atm


def _build_model_from_phot(s: Settings, table: photio.PhotTable):
    from base_tpu.grids.load import make_model
    from base_tpu.model import posterior as post
    from base_tpu.model.stardata import make_ms_stars

    bundle = make_model(s)
    stage = table.stage
    is_wd = stage == C.StarStatus.WD
    has_wd = bool(is_wd.any())
    table, ms_grid, wd_atm = _active_bands(
        table, bundle.ms, bundle.wd_atm if has_wd else None
    )
    bundle = bundle._replace(
        ms=ms_grid, wd_atm=wd_atm if has_wd else bundle.wd_atm
    )
    usable = (stage == C.StarStatus.MSRG) | is_wd
    ms_rows = table.select(usable & ~is_wd)
    wd_rows = table.select(is_wd)
    frange = s.cluster.field_mag_range_array(ms_rows.mags.shape[1])
    ms = make_ms_stars(ms_rows.mags, ms_rows.sigmas, cm_prior=ms_rows.cm_prior,
                       field_mag_range=frange,
                       sigma_model=s.mcmc.sigmaModel)
    wds = None
    if wd_rows.n_stars > 0:
        wds = make_ms_stars(
            wd_rows.mags, wd_rows.sigmas, cm_prior=wd_rows.cm_prior,
            field_mag_range=s.cluster.field_mag_range_array(
                wd_rows.mags.shape[1]),
            sigma_model=s.mcmc.sigmaModel,
        )
    model = post.make_single_pop_model(
        bundle.ms, ms,
        prior_mean=s.cluster.prior_mean_vector(),
        prior_sigma=s.cluster.prior_sigma_vector(),
        n_q=s.mcmc.nMassRatio,
        binaries=not s.mcmc.noBinaries,
        wd_cooling=None if wds is None else bundle.wd_cooling,
        wd_atm=None if wds is None else bundle.wd_atm,
        wd_stars=wds,
        ifmr_kind=bundle.ifmr_kind,
        p_db=s.simCluster.percentDB,
        upsample=s.mcmc.upsample,
    )
    return model


def _parse_mesh(spec: str | None):
    """--mesh C,S -> a (chains x stars) Mesh over the available devices;
    None when no mesh was requested (single-device vmap path)."""
    if not spec:
        return None
    from base_tpu.parallel.mesh import make_mesh

    parts = [int(x) for x in spec.split(",")]
    if len(parts) == 1:
        parts.append(1)
    if len(parts) != 2:
        raise SystemExit(f"--mesh wants C,S (got {spec!r})")
    return make_mesh(n_chain_shards=parts[0], n_star_shards=parts[1])


def _announce_draws(s: Settings, n_chains: int) -> None:
    """Loud per-chain draw count: mcmc.runIter is TOTAL recorded draws
    across chains here (the reference's runIter is per its single chain
    — docs/MIGRATION.md), so a ported config would otherwise silently
    run n_chains x fewer draws per chain than its author expects."""
    per = s.mcmc.runIter // max(n_chains, 1)
    print(
        f"mcmc.runIter = {s.mcmc.runIter} TOTAL recorded draws across "
        f"{n_chains} chains -> {per} draws/chain (thin={s.mcmc.thin}; "
        f"reference runIter is per-chain — see docs/MIGRATION.md)"
    )


def _window_logger(mlog, names):
    """Streaming per-window diagnostics hook for the chunked driver:
    R-hat/ESS/acceptance per recorded window, not one post-hoc row
    (SURVEY.md §5 metrics plan)."""
    import numpy as np

    from base_tpu.inference import diagnostics as diag

    def on_window(ci, zs, lps):
        import jax.numpy as jnp

        rhat = np.asarray(diag.split_rhat(jnp.asarray(zs)))
        ess = np.asarray(diag.ess(jnp.asarray(zs)))
        mlog.log(
            "window",
            window=ci,
            n=int(zs.shape[0]) * int(zs.shape[1]),
            logpost_mean=float(np.mean(np.asarray(lps))),
            **{f"rhat_{n}": float(rhat[i]) for i, n in enumerate(names)},
            **{f"ess_{n}": float(ess[i]) for i, n in enumerate(names)},
        )

    return on_window


def cmd_single_pop(args) -> None:
    import jax
    import jax.numpy as jnp

    from base_tpu.inference import diagnostics as diag
    from base_tpu.inference.hmc import HMCConfig, run_hmc
    from base_tpu.inference.mh import MHConfig, run_adaptive_mh
    from base_tpu.model import posterior as post

    import time

    s = _settings(args)
    table = photio.read_phot(s.files.photFile)
    model = _build_model_from_phot(s, table)
    key = jax.random.PRNGKey(s.mcmc.seed)
    start = s.cluster.start_vector()
    n_chains = s.mcmc.chains
    _announce_draws(s, n_chains)
    mesh = _parse_mesh(getattr(args, "mesh", None))
    resume = bool(getattr(args, "resume", False))
    ckpt_path = s.files.outputFileBase + ".ckpt" if resume else None
    if resume and s.mcmc.sampler != "hmc":
        print(
            f"single-pop: --resume is checkpointed-HMC only; "
            f"sampler={s.mcmc.sampler} runs without checkpoints",
            file=sys.stderr,
        )
    mlog = None
    if args.metrics:
        from base_tpu.utils.metrics import MetricsLogger

        mlog = MetricsLogger(args.metrics)
    t_sample0 = time.perf_counter()

    if s.mcmc.sampler in ("hmc", "nuts", "smc", "vi"):
        tr = post.default_transform(model)
        fz = post.make_logpost_z_fn(model, tr)
        z0 = tr.inverse(jnp.asarray(start))
        init = jnp.tile(z0[None, :], (n_chains, 1))
        init = init + 0.02 * jax.random.normal(key, init.shape)
        if s.mcmc.sampler == "nuts":
            from base_tpu.inference.nuts import NUTSConfig, run_nuts

            ncfg = NUTSConfig(
                n_warmup=s.mcmc.warmup,
                n_samples=s.mcmc.runIter // n_chains,
                thin=s.mcmc.thin, target_accept=s.mcmc.targetAccept,
                dense_mass=s.mcmc.denseMass,
                free_mask=post.free_mask(model),
            )
            if mesh is not None:
                from base_tpu.parallel.run import run_nuts_sharded

                zs, info = run_nuts_sharded(
                    model, tr, init, jax.random.fold_in(key, 1), ncfg, mesh
                )
                lps = jax.vmap(jax.vmap(fz))(zs)
            else:
                # Host-chunked executions (see the hmc path below).
                from base_tpu.inference.nuts import make_nuts_chunked_runner

                zs, info = make_nuts_chunked_runner(fz, ncfg)(
                    init, jax.random.fold_in(key, 1)
                )
                lps = info["logposts"]
            accept = float(info["accept_prob"])
        elif s.mcmc.sampler == "smc":
            from base_tpu.inference.smc import SMCConfig, run_smc

            n_part = max(s.mcmc.runIter, 256)
            sd0 = 0.5

            def log_q0(z):
                return jnp.sum(
                    -0.5 * ((z - z0) / sd0) ** 2
                    - jnp.log(sd0) - 0.9189385
                )

            def sample_q0(k, n):
                return z0[None, :] + sd0 * jax.random.normal(
                    k, (n, z0.shape[0])
                )

            if mesh is not None:
                from base_tpu.parallel.mesh import CHAIN_AXIS
                from base_tpu.parallel.run import run_smc_sharded

                scfg = SMCConfig(
                    n_particles=max(n_part // mesh.shape[CHAIN_AXIS], 64)
                )
                z_part, info = run_smc_sharded(
                    model, tr, z0, jax.random.fold_in(key, 2), scfg, mesh,
                    q0_sd=sd0,
                )
            else:
                # 4 independent replicates, stage-chunked (one device
                # execution per tempering stage) with a repeat-run
                # evidence SE.
                from base_tpu.inference.smc import make_smc_chunked_runner

                n_rep = 4
                scfg = SMCConfig(n_particles=max(n_part // n_rep, 64))
                z_part, info = make_smc_chunked_runner(
                    fz, sample_q0, log_q0, scfg, n_rep=n_rep
                )(jax.random.fold_in(key, 2))
            zs = z_part[:, None, :]      # [N, 1, P]
            lps = jax.vmap(fz)(z_part)[:, None]
            accept = float(info["accept"])
            se = (
                f" +- {float(info['log_evidence_se']):.2f}"
                if "log_evidence_se" in info else ""
            )
            print(
                f"  smc: log_evidence={float(info['log_evidence']):.2f}"
                f"{se} stages={int(info['n_stages'])} "
                f"move_accept={accept:.2f} "
                f"move_scale={float(info['move_scale']):.3f}"
            )
        elif s.mcmc.sampler == "vi":
            from base_tpu.inference.vi import (
                VIConfig, run_vi, sample_posterior,
            )

            vcfg = VIConfig(n_steps=max(s.mcmc.warmup * 3, 600),
                            full_rank=True)
            res = jax.jit(lambda k: run_vi(fz, z0, k, vcfg))(
                jax.random.fold_in(key, 3)
            )
            n_draw = max(s.mcmc.runIter, 256)
            z_part = sample_posterior(
                res, jax.random.fold_in(key, 4), n_draw
            )
            zs = z_part[:, None, :]
            lps = jax.vmap(fz)(z_part)[:, None]
            accept = float(res.final_elbo)
            print(f"  vi: final ELBO={float(res.final_elbo):.2f}")
        else:
            # Pin density-flat dims (carbonicity / IFMR coefficients
            # without a WD branch) — mirrors the MH path's step-scale-0
            # pinning and keeps the warmup metric well-conditioned.
            cfg = HMCConfig(
                n_warmup=s.mcmc.warmup,
                n_samples=s.mcmc.runIter // n_chains,
                thin=s.mcmc.thin, l_max=s.mcmc.lMax,
                target_accept=s.mcmc.targetAccept,
                dense_mass=s.mcmc.denseMass,
                free_mask=post.free_mask(model),
            )
            hkey = jax.random.fold_in(key, 1)
            chunked = resume or mlog is not None
            if chunked:
                # Chunked driver: checkpoint/resume (--resume) and/or
                # per-window streaming diagnostics (--metrics).
                from base_tpu.inference.driver import DriverConfig

                dcfg = DriverConfig(
                    checkpoint_path=ckpt_path,
                    chunk_size=max(
                        min(100, (s.mcmc.runIter // n_chains) // 4), 1
                    ),
                    on_window=(
                        _window_logger(mlog, C.PARAM_NAMES)
                        if mlog is not None else None
                    ),
                )
                if mesh is not None:
                    from base_tpu.parallel.run import (
                        run_hmc_sharded_checkpointed,
                    )

                    zs, info = run_hmc_sharded_checkpointed(
                        model, tr, init, hkey, cfg, mesh, dcfg
                    )
                else:
                    from base_tpu.inference.driver import (
                        run_hmc_checkpointed,
                    )

                    zs, info = run_hmc_checkpointed(
                        fz, init, hkey, cfg, dcfg
                    )
            elif mesh is not None:
                from base_tpu.parallel.run import run_hmc_sharded

                zs, info = run_hmc_sharded(model, tr, init, hkey, cfg, mesh)
            else:
                # Host-chunked executions (bit-identical to run_hmc):
                # one device execution per warmup window and per chunk.
                from base_tpu.inference.driver import run_hmc_chunked

                zs, info = run_hmc_chunked(fz, init, hkey, cfg)
            accept = float(info["accept_prob"])
            lps = info["logposts"]
        xs = jax.vmap(jax.vmap(tr.forward))(zs)          # [N, C, 9]
    else:
        f = post.make_logpost_fn(model)
        # Reference-style per-param step scales, masked by the shared
        # sampled-parameter helper so MH frees exactly what HMC/NUTS do
        # (incl. the quadratic IFMR coefficient under ifmr=quadratic).
        step0 = np.array(
            [0.05, 0.02, 0.05, 0.05, 0.03, 0.02, 0.02, 0.02, 0.005],
            np.float32,
        ) * np.asarray(post.free_mask(model), np.float32)
        cfg = MHConfig(
            n_stage1=s.mcmc.stage1Iter, n_stage2=s.mcmc.stage2IterMax,
            n_main=s.mcmc.runIter // n_chains, thin=s.mcmc.thin,
        )
        # useDuringBurnIn: stages 1-2 target only the flagged stars
        # (reference C3/C14 semantics); stage 3 uses everything.
        f_burn = None
        if (table.use_dbi == 0).any():
            burn_model = _build_model_from_phot(
                s, table.select(table.use_dbi != 0)
            )
            f_burn = post.make_logpost_fn(burn_model)
        keys = jax.random.split(key, n_chains)
        init = jnp.tile(jnp.asarray(start)[None, :], (n_chains, 1))
        if mesh is not None:
            from base_tpu.parallel.run import run_mh_sharded

            # useDuringBurnIn under a mesh: the burn-in subset model
            # shards over the same star axis (run_mh_sharded burn_model).
            xs, info = run_mh_sharded(
                model, init, key, jnp.asarray(step0), cfg, mesh,
                burn_model=(
                    _build_model_from_phot(s, table.select(table.use_dbi != 0))
                    if f_burn is not None else None
                ),
            )
            lps = jnp.swapaxes(info["logposts"], 0, 1)
            accept = float(np.asarray(info["accept_rate"]))
        else:
            samples, info = jax.jit(jax.vmap(
                lambda p, k: run_adaptive_mh(
                    f, p, k, jnp.asarray(step0), cfg,
                    logpost_burnin_fn=f_burn,
                )
            ))(init, keys)
            xs = jnp.swapaxes(samples, 0, 1)             # [N, C, 9]
            lps = jnp.swapaxes(info["logposts"], 0, 1)   # [N, C]
            accept = float(np.mean(np.asarray(info["accept_rate"])))

    wall = time.perf_counter() - t_sample0
    out = s.files.outputFileBase + ".res"
    resio.write_res(out, np.asarray(xs), np.asarray(lps).reshape(xs.shape[0], -1))
    if s.files.store == "sqlite":
        from base_tpu.io.sqlite_store import write_res_sqlite

        db = s.files.outputFileBase + ".db"
        write_res_sqlite(
            db, np.asarray(xs), np.asarray(lps).reshape(xs.shape[0], -1),
            meta={"sampler": s.mcmc.sampler, "seed": s.mcmc.seed,
                  "chains": s.mcmc.chains, "tool": "single-pop"},
        )
        print(f"  sqlite store -> {db}")
    summ = diag.summarize(jnp.asarray(xs), C.PARAM_NAMES)
    if mlog is not None:
        n_evals = xs.shape[0] * xs.shape[1] * (
            s.mcmc.lMax if s.mcmc.sampler == "hmc" else 1
        )
        mlog.throughput(
            "single-pop", n_samples=xs.shape[0] * xs.shape[1],
            n_evals=n_evals, seconds=wall, sampler=s.mcmc.sampler,
            accept=accept, ess_age=float(summ["ess"][0]),
            rhat_age=float(summ["rhat"][0]), stars=int(table.n_stars),
            chains=n_chains,
        )
        mlog.close()
    print(f"single-pop ({s.mcmc.sampler}): {xs.shape[0]}x{xs.shape[1]} samples -> {out}")
    print(f"  accept={accept:.3f}")
    for i, name in enumerate(C.PARAM_NAMES[:6]):
        print(
            f"  {name:12s} mean={summ['mean'][i]: .4f} sd={summ['sd'][i]:.4f}"
            f" rhat={summ['rhat'][i]:.3f} ess={summ['ess'][i]:.0f}"
        )


def cmd_sample_mass(args) -> None:
    import jax
    import jax.numpy as jnp

    from base_tpu.model import conditionals as cond

    s = _settings(args)
    table = photio.read_phot(s.files.photFile)
    model = _build_model_from_phot(s, table)
    chain = resio.read_res(s.files.outputFileBase + ".res")
    thin = max(len(chain.params) // 200, 1)
    draws = jnp.asarray(chain.params[::thin])
    out = cond.sample_ms_masses(
        model, draws, jax.random.PRNGKey(s.mcmc.seed + 2)
    )
    from base_tpu.io.samples import write_star_samples

    ids = table.select(table.stage == C.StarStatus.MSRG).ids
    path = s.files.outputFileBase + ".massSamples"
    write_star_samples(
        path, ids,
        {"mass": np.asarray(out.mass1),
         "massRatio": np.asarray(out.mass_ratio)},
    )
    mpath = s.files.outputFileBase + ".membership"
    write_star_samples(
        mpath, ids, {"pMember": np.asarray(out.p_member)}, fmt="%.5f"
    )
    print(
        f"sample-mass: {draws.shape[0]} draws x {out.mass1.shape[1]} stars "
        f"-> {path} (+ membership -> {mpath})"
    )
    pm = np.asarray(out.p_member).mean(0)
    lo = np.argsort(pm)[: min(5, len(pm))]
    for i in lo:
        if pm[i] < 0.5:
            print(f"  likely field star {ids[i]}: P(member)={pm[i]:.3f}")


def cmd_sample_wd_mass(args) -> None:
    import jax
    import jax.numpy as jnp

    from base_tpu.model import conditionals as cond

    s = _settings(args)
    table = photio.read_phot(s.files.photFile)
    model = _build_model_from_phot(s, table)
    if model.wd_stars is None:
        print("sample-wd-mass: no WD stars in photometry", file=sys.stderr)
        sys.exit(1)
    chain = resio.read_res(s.files.outputFileBase + ".res")
    thin = max(len(chain.params) // 200, 1)
    draws = jnp.asarray(chain.params[::thin])
    out = cond.sample_wd_masses(
        model, draws, jax.random.PRNGKey(s.mcmc.seed + 3)
    )
    from base_tpu.io.samples import write_star_samples

    ids = table.select(table.stage == C.StarStatus.WD).ids
    path = s.files.outputFileBase + ".wdMassSamples"
    write_star_samples(
        path, ids,
        {"zamsMass": np.asarray(out.zams_mass),
         "wdMass": np.asarray(out.wd_mass),
         "logCoolAge": np.asarray(out.log_cool_age),
         "isDB": np.asarray(out.is_db, np.float32),
         "pMember": np.asarray(out.p_member)},
    )
    print(
        f"sample-wd-mass: {draws.shape[0]} draws x {out.zams_mass.shape[1]} WDs -> {path}"
    )


def cmd_multi_pop(args) -> None:
    """Two-population helium-spread sampler (multiPopMcmc analog).

    All five samplers run here, single-device or --mesh sharded, through
    the model-agnostic parallel.run machinery: hmc (default) and nuts
    gradient-sample through the ORDERED (Y_A, dY>0) transform (the
    label-switching mode is cut away by the bijection); smc runs
    tempered SMC with a replicated (or mesh-pooled) evidence estimate;
    vi fits full-rank ADVI (mesh: MC-sharded ELBO, parallel.run.
    run_vi_sharded); mh is the reference-parity 3-stage adaptive MH on
    the constrained 12-vector.  WDs in the .phot evaluate against both
    populations' precursor chains (lambda-mixed)."""
    import jax
    import jax.numpy as jnp

    from base_tpu.grids.load import make_model
    from base_tpu.inference import diagnostics as diag
    from base_tpu.inference.hmc import HMCConfig
    from base_tpu.model import multipop as mp
    from base_tpu.model.stardata import make_ms_stars

    s = _settings(args)
    table = photio.read_phot(s.files.photFile)
    bundle = make_model(s)
    rows = table.select(table.stage == C.StarStatus.MSRG)
    stars = make_ms_stars(rows.mags, rows.sigmas, cm_prior=rows.cm_prior,
                          field_mag_range=s.cluster.field_mag_range_array(
                              rows.mags.shape[1]),
                          sigma_model=s.mcmc.sigmaModel)
    wd_kwargs = {}
    wd_rows = table.select(table.stage == C.StarStatus.WD)
    if wd_rows.n_stars > 0:
        wd_kwargs = dict(
            wd_cooling=bundle.wd_cooling,
            wd_atm=bundle.wd_atm,
            wd_stars=make_ms_stars(
                wd_rows.mags, wd_rows.sigmas, cm_prior=wd_rows.cm_prior,
                field_mag_range=s.cluster.field_mag_range_array(
                    wd_rows.mags.shape[1]),
            ),
            ifmr_kind=bundle.ifmr_kind,
            p_db=s.simCluster.percentDB,
        )

    start9 = s.cluster.start_vector()
    y0 = float(start9[C.Param.YYY])
    # multiPop section [upstream: Settings multiPop YA/YB/lambda starts &
    # steps — SURVEY.md C12]: NaN starts/priors derive from cluster Y.
    mpset = s.multiPop
    ya0 = mpset.startY_A if np.isfinite(mpset.startY_A) else y0 - 0.02
    yb0 = mpset.startY_B if np.isfinite(mpset.startY_B) else y0 + 0.02
    if not ya0 < yb0:
        # The ordered transform's inverse needs dY > 0; an inverted
        # start would silently produce NaN initial positions.
        print(
            f"multi-pop: startY_A ({ya0}) must be < startY_B ({yb0}) — "
            f"the populations are identified by Y_A < Y_B",
            file=sys.stderr,
        )
        raise SystemExit(2)
    lam0 = float(np.clip(mpset.startLambda, 1e-3, 1.0 - 1e-3))
    pm_ya = mpset.priorY_A if np.isfinite(mpset.priorY_A) else ya0
    pm_yb = mpset.priorY_B if np.isfinite(mpset.priorY_B) else yb0
    prior_mean = np.concatenate(
        [s.cluster.prior_mean_vector(),
         np.asarray([pm_ya, pm_yb, mpset.priorLambda], np.float32)]
    )
    prior_sigma = np.concatenate(
        [s.cluster.prior_sigma_vector(),
         np.asarray([mpset.priorY_A_sigma, mpset.priorY_B_sigma,
                     mpset.priorLambda_sigma], np.float32)]
    )
    model = mp.make_multipop_model(
        bundle.ms, stars, prior_mean, prior_sigma,
        n_q=s.mcmc.nMassRatio, binaries=not s.mcmc.noBinaries,
        upsample=s.mcmc.upsample,
        **wd_kwargs,
    )
    start = np.concatenate(
        [start9, np.asarray([ya0, yb0, lam0], np.float32)]
    )
    key = jax.random.PRNGKey(s.mcmc.seed)
    n_chains = s.mcmc.chains
    _announce_draws(s, n_chains)
    mesh = _parse_mesh(getattr(args, "mesh", None))
    resume = bool(getattr(args, "resume", False))
    ckpt_path = s.files.outputFileBase + ".mp.ckpt" if resume else None
    if resume and s.mcmc.sampler != "hmc":
        print(
            f"multi-pop: --resume is checkpointed-HMC only; "
            f"sampler={s.mcmc.sampler} runs without checkpoints",
            file=sys.stderr,
        )

    if s.mcmc.sampler == "mh":
        from base_tpu.inference.mh import MHConfig, run_adaptive_mh

        f = mp.make_logpost_fn(model)
        step0 = np.zeros(mp.NPARAMS_MP, np.float32)
        step0[[0, 2, 3, 4]] = [0.05, 0.05, 0.05, 0.03]
        step0[mp.MP_YYA] = mpset.stepY_A
        step0[mp.MP_YYB] = mpset.stepY_B
        step0[mp.MP_LAMBDA] = mpset.stepLambda
        cfg = MHConfig(
            n_stage1=s.mcmc.stage1Iter, n_stage2=s.mcmc.stage2IterMax,
            n_main=s.mcmc.runIter // n_chains, thin=s.mcmc.thin,
        )
        init = jnp.tile(jnp.asarray(start)[None, :], (n_chains, 1))
        if mesh is not None:
            from base_tpu.parallel.run import run_mh_sharded

            samples_nc, info = run_mh_sharded(
                model, init, key, jnp.asarray(step0), cfg, mesh
            )
            xs = np.asarray(samples_nc)
            lps = np.asarray(jnp.swapaxes(info["logposts"], 0, 1))
            accept = float(np.asarray(info["accept_rate"]))
        else:
            keys = jax.random.split(key, n_chains)
            samples, info = jax.jit(jax.vmap(
                lambda p, k: run_adaptive_mh(
                    f, p, k, jnp.asarray(step0), cfg
                )
            ))(init, keys)
            xs = np.asarray(jnp.swapaxes(samples, 0, 1))
            lps = np.asarray(jnp.swapaxes(info["logposts"], 0, 1))
            accept = float(np.mean(np.asarray(info["accept_rate"])))
    elif s.mcmc.sampler == "nuts":
        from base_tpu.inference.nuts import NUTSConfig, make_nuts_chunked_runner

        tr = mp.ordered_transform(model)
        fz = mp.make_logpost_z_fn(model, tr)
        z0 = tr.inverse(jnp.asarray(start))
        init = jnp.tile(z0[None, :], (n_chains, 1))
        init = init + 0.02 * jax.random.normal(key, init.shape)
        ncfg = NUTSConfig(
            n_warmup=s.mcmc.warmup, n_samples=s.mcmc.runIter // n_chains,
            thin=s.mcmc.thin, target_accept=s.mcmc.targetAccept,
            dense_mass=s.mcmc.denseMass, free_mask=mp.free_mask(model),
        )
        if mesh is not None:
            from base_tpu.parallel.run import run_nuts_sharded

            zs, info = run_nuts_sharded(
                model, tr, init, jax.random.fold_in(key, 1), ncfg, mesh
            )
            lps = jax.vmap(jax.vmap(fz))(zs)
        else:
            zs, info = make_nuts_chunked_runner(fz, ncfg)(
                init, jax.random.fold_in(key, 1)
            )
            lps = info["logposts"]
        xs = np.asarray(jax.vmap(jax.vmap(tr.forward))(zs))
        lps = np.asarray(lps)
        accept = float(info["accept_prob"])
    elif s.mcmc.sampler == "smc":
        from base_tpu.inference.smc import SMCConfig

        tr = mp.ordered_transform(model)
        fz = mp.make_logpost_z_fn(model, tr)
        z0 = tr.inverse(jnp.asarray(start))
        n_part = max(s.mcmc.runIter, 256)
        sd0 = 0.5

        def log_q0(z):
            return jnp.sum(-0.5 * ((z - z0) / sd0) ** 2
                           - jnp.log(sd0) - 0.9189385)

        def sample_q0(k, n):
            return z0[None, :] + sd0 * jax.random.normal(
                k, (n, z0.shape[0])
            )

        if mesh is not None:
            from base_tpu.parallel.mesh import CHAIN_AXIS
            from base_tpu.parallel.run import run_smc_sharded

            scfg = SMCConfig(
                n_particles=max(n_part // mesh.shape[CHAIN_AXIS], 64)
            )
            z_part, info = run_smc_sharded(
                model, tr, z0, jax.random.fold_in(key, 2), scfg, mesh,
                q0_sd=sd0,
            )
        else:
            from base_tpu.inference.smc import make_smc_chunked_runner

            n_rep = 4
            scfg = SMCConfig(n_particles=max(n_part // n_rep, 64))
            z_part, info = make_smc_chunked_runner(
                fz, sample_q0, log_q0, scfg, n_rep=n_rep
            )(jax.random.fold_in(key, 2))
        xs = np.asarray(jax.vmap(tr.forward)(z_part))[:, None, :]
        lps = np.asarray(jax.vmap(fz)(z_part))[:, None]
        accept = float(info["accept"])
        se = (f" +- {float(info['log_evidence_se']):.2f}"
              if "log_evidence_se" in info else "")
        print(
            f"  smc: log_evidence={float(info['log_evidence']):.2f}{se} "
            f"stages={int(info['n_stages'])} move_accept={accept:.2f}"
        )
    elif s.mcmc.sampler == "vi":
        from base_tpu.inference.vi import VIConfig, run_vi, sample_posterior

        tr = mp.ordered_transform(model)
        fz = mp.make_logpost_z_fn(model, tr)
        z0 = tr.inverse(jnp.asarray(start))
        vcfg = VIConfig(n_steps=max(s.mcmc.warmup * 3, 600), full_rank=True)
        if mesh is not None:
            from base_tpu.parallel.run import run_vi_sharded

            res = run_vi_sharded(
                model, tr, z0, jax.random.fold_in(key, 3), vcfg, mesh
            )
        else:
            res = jax.jit(lambda k: run_vi(fz, z0, k, vcfg))(
                jax.random.fold_in(key, 3)
            )
        n_draw = max(s.mcmc.runIter, 256)
        z_part = sample_posterior(res, jax.random.fold_in(key, 4), n_draw)
        xs = np.asarray(jax.vmap(tr.forward)(z_part))[:, None, :]
        lps = np.asarray(jax.vmap(fz)(z_part))[:, None]
        accept = float(res.final_elbo)
        print(f"  vi: final ELBO={float(res.final_elbo):.2f}")
    else:
        tr = mp.ordered_transform(model)
        fz = mp.make_logpost_z_fn(model, tr)
        z0 = tr.inverse(jnp.asarray(start))
        init = jnp.tile(z0[None, :], (n_chains, 1))
        init = init + 0.02 * jax.random.normal(key, init.shape)
        cfg = HMCConfig(
            n_warmup=s.mcmc.warmup, n_samples=s.mcmc.runIter // n_chains,
            thin=s.mcmc.thin, l_max=s.mcmc.lMax,
            target_accept=s.mcmc.targetAccept,
            dense_mass=s.mcmc.denseMass,
            free_mask=mp.free_mask(model),
        )
        hkey = jax.random.fold_in(key, 1)
        if mesh is not None or resume:
            # Sharded and/or checkpointed: the generic driver loop over
            # the model-agnostic shard_map'd (warm, step) pair — the
            # exact machinery single-pop production runs use.
            from base_tpu.inference.driver import DriverConfig

            dcfg = DriverConfig(
                checkpoint_path=ckpt_path,
                chunk_size=max(
                    min(100, (s.mcmc.runIter // n_chains) // 4), 1
                ),
            )
            if mesh is not None:
                from base_tpu.parallel.run import (
                    run_hmc_sharded_checkpointed,
                )

                zs, info = run_hmc_sharded_checkpointed(
                    model, tr, init, hkey, cfg, mesh, dcfg
                )
            else:
                from base_tpu.inference.driver import run_hmc_checkpointed

                zs, info = run_hmc_checkpointed(fz, init, hkey, cfg, dcfg)
        else:
            # Host-chunked executions (bit-identical to run_hmc) — same
            # driver as single-pop.
            from base_tpu.inference.driver import run_hmc_chunked

            zs, info = run_hmc_chunked(fz, init, hkey, cfg)
        xs = np.asarray(jax.vmap(jax.vmap(tr.forward))(zs))
        lps = np.asarray(info["logposts"])
        accept = float(info["accept_prob"])

    out = s.files.outputFileBase + ".mp.res"
    cols = list(mp.MP_PARAM_NAMES) + ["logPost", "chain"]
    with open(out, "w") as f:
        f.write(" ".join(cols) + "\n")
        for n in range(xs.shape[0]):
            for c in range(xs.shape[1]):
                row = [f"{v:.6f}" for v in xs[n, c]]
                row += [f"{lps[n, c]:.4f}", str(c)]
                f.write(" ".join(row) + "\n")
    if s.files.store == "sqlite":
        from base_tpu.io.sqlite_store import write_res_sqlite

        db = s.files.outputFileBase + ".db"
        write_res_sqlite(
            db, xs, lps, columns=tuple(mp.MP_PARAM_NAMES),
            meta={"sampler": s.mcmc.sampler, "seed": s.mcmc.seed,
                  "chains": s.mcmc.chains, "tool": "multi-pop"},
        )
        print(f"  sqlite store -> {db}")
    summ = diag.summarize(jnp.asarray(xs), mp.MP_PARAM_NAMES)
    print(
        f"multi-pop ({s.mcmc.sampler}): {xs.shape[0]}x{xs.shape[1]} "
        f"samples -> {out}"
    )
    print(f"  accept={accept:.3f}")
    for i in [0, 2, 3, 4, mp.MP_YYA, mp.MP_YYB, mp.MP_LAMBDA]:
        name = mp.MP_PARAM_NAMES[i]
        print(
            f"  {name:12s} mean={summ['mean'][i]: .4f} "
            f"sd={summ['sd'][i]:.4f} rhat={summ['rhat'][i]:.3f}"
        )


def cmd_make_cmd(args) -> None:
    """Write the model CMD sequence at the truth parameters: upsampled
    MS/RGB isochrone plus the WD cooling sequence [upstream: makeCMD —
    SURVEY.md E7]."""
    import jax
    import jax.numpy as jnp

    from base_tpu.grids.load import make_model
    from base_tpu.grids.isochrone import derive_isochrone, upsample_isochrone

    s = _settings(args)
    bundle = make_model(s)
    p = _truth_params(s)
    iso = derive_isochrone(
        bundle.ms, p[C.Param.FEH], p[C.Param.YYY], p[C.Param.AGE]
    )
    # Exact (piecewise-linear) refinement so the written sequence is a
    # smooth curve rather than the raw EEP nodes.
    iso = upsample_isochrone(iso, factor=4)
    from base_tpu.grids import filters as filt

    dist = p[C.Param.MOD] + p[C.Param.ABS] * filt.absorption_coefs(
        bundle.ms.bands
    )
    app = np.asarray(iso.mags) + dist[None, :]
    valid = np.asarray(iso.valid) > 0.5
    out = s.files.outputFileBase + ".cmd"
    with open(out, "w") as f:
        f.write("stage mass " + " ".join(bundle.ms.bands) + "\n")
        for m, row in zip(np.asarray(iso.mass)[valid], app[valid]):
            f.write(f"MS {m:.6f} "
                    + " ".join(f"{v:.4f}" for v in row) + "\n")
        n_wd = 0
        if bundle.wd_cooling is not None and bundle.wd_atm is not None:
            from base_tpu.grids.wd_atmosphere import wd_mags as atm_mags
            from base_tpu.grids.wd_cooling import wd_teff_radius
            from base_tpu.model import ifmr as ifmr_mod
            from base_tpu.model import wd as wd_mod

            # WD sequence: ZAMS masses from just above the AGB tip to the
            # max precursor mass, evolved through IFMR -> cooling ->
            # atmosphere (DA) exactly as the likelihood's WD branch.
            tip = float(iso.agb_tip)
            start = tip * 1.01
            if start >= float(C.MAX_WD_PRECURSOR_MASS):
                # Young cluster: the AGB tip already exceeds the largest
                # WD precursor — there is no WD sequence to draw (an
                # increasing linspace from here would fabricate one).
                print(f"make-cmd: {valid.sum()} MS nodes + 0 WD nodes "
                      f"(AGB tip {tip:.2f} above max precursor) -> {out}")
                return
            prec_m = jnp.linspace(start, float(C.MAX_WD_PRECURSOR_MASS), 64)
            pj = jnp.asarray(p)
            prec = wd_mod.wd_prec_logage(
                bundle.ms, pj[C.Param.FEH], pj[C.Param.YYY], prec_m)
            delta = jnp.clip(prec - pj[C.Param.AGE], -30.0, -1e-4)
            log_cool = pj[C.Param.AGE] + jnp.log10(1.0 - 10.0 ** delta)
            m_wd = ifmr_mod.ifmr_mass(bundle.ifmr_kind, prec_m, pj)
            lt, lr, cool_ok = jax.vmap(
                lambda m, a: wd_teff_radius(
                    bundle.wd_cooling, pj[C.Param.CARBONICITY], m, a)
            )(m_wd, log_cool)
            logg = (wd_mod.LOG_G_SUN
                    + jnp.log10(jnp.maximum(m_wd, 1e-3)) - 2.0 * lr)
            mda, ok = jax.vmap(
                lambda t, g: atm_mags(bundle.wd_atm, t, g, 0))(lt, logg)
            wd_app = np.asarray(mda) + dist[None, :]
            # A node is real only when BOTH interpolations are in-hull:
            # the cooling grid's flag (clamped Teff/radius otherwise) and
            # the atmosphere grid's — same validity rule as the
            # likelihood's WD branch (model/wd.py wd_model_mags).
            wd_ok = np.asarray(ok) > 0.5 if np.ndim(ok) else np.ones(
                wd_app.shape[0], bool)
            wd_ok = wd_ok & (np.asarray(cool_ok) > 0.5)
            for m, row, good in zip(np.asarray(prec_m), wd_app, wd_ok):
                if good and np.isfinite(row).all():
                    f.write(f"WD {m:.6f} "
                            + " ".join(f"{v:.4f}" for v in row) + "\n")
                    n_wd += 1
    print(f"make-cmd: {valid.sum()} MS nodes + {n_wd} WD nodes -> {out}")


def cmd_convert_models(args) -> None:
    """Pack upstream-format text grids into the .npz containers load.py
    serves (ingestion pipeline for the separately-distributed model data,
    SURVEY.md L0/§7 step 0)."""
    from base_tpu.grids.parse import convert_model_directory

    s = _settings(args)
    src = args.src or s.files.modelDirectory
    dst = args.dst or s.files.modelDirectory
    if not src or not dst:
        raise SystemExit("convert-models: pass --src <textdir> --dst "
                         "<npzdir> (or set modelDirectory)")
    written = convert_model_directory(src, dst)
    for w in written:
        print(f"convert-models: wrote {w}")
    if not written:
        print("convert-models: no recognized grid files found")


TOOLS = {
    "simulate": cmd_simulate,
    "scatter": cmd_scatter,
    "single-pop": cmd_single_pop,
    "multi-pop": cmd_multi_pop,
    "sample-mass": cmd_sample_mass,
    "sample-wd-mass": cmd_sample_wd_mass,
    "make-cmd": cmd_make_cmd,
    "convert-models": cmd_convert_models,
}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="base-tpu")
    sub = parser.add_subparsers(dest="tool", required=True)
    for name in TOOLS:
        p = sub.add_parser(name)
        _common(p)
        if name == "convert-models":
            p.add_argument("--src", default=None,
                           help="directory of upstream-format text grids")
            p.add_argument("--dst", default=None,
                           help="output directory for packed .npz grids")
    args = parser.parse_args(argv)
    from base_tpu.utils.metrics import profile_trace

    with profile_trace(args.profile):
        TOOLS[args.tool](args)


if __name__ == "__main__":
    from base_tpu.platform import setup_compile_cache

    setup_compile_cache()
    main()
