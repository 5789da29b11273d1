"""Run base-tpu's main path once on the GPU and check what comes out.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded 2 x 2 path only

One card:
  1. device: JAX's device, and the card's name and power limit;
  2. kernel parity: the fused marginal kernel against the plain jnp
     marginal at the shipped default widths (about 100 stars, 5056
     segments, 8 bands), forward and gradient, vmapped over 64 tables;
  3. precision: log_post and its gradient at 64 points on the GPU and on
     the CPU in one process (TF32 anywhere would show as ~1e-3);
  4. the CLI end to end at the shipped defaults (conf/base9.yaml):
     simulate -> scatter -> single-pop (HMC), warmup and draws cut;
  5. the white-dwarf branch: a short single-pop on a cluster with WDs;
  6. resume: a checkpointed HMC run stopped after its first chunk and
     resumed equals an uninterrupted run, bit for bit.

Four cards (--four): the sharded log_post and gradient on a (chains x
stars) = 2 x 2 mesh against one card, a short `single-pop --mesh 2,2`,
and a check that every card holds its shard.

A failing phase raises, so the script exits non-zero; so does a run
without a GPU, before any work.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CONF = ROOT / "conf" / "base9.yaml"
N_CHAINS = 64
# Sampled dims of an MS-only run: age, Y, [Fe/H], modulus, A_V.
FREE = np.array([1, 1, 1, 1, 1, 0, 0, 0, 0], np.float32)


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of each card (a child process
    that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def config1_model(n_stars: int = 100, seed: int = 0, sets=()):
    """The shipped-default model (conf/base9.yaml: synthetic grid, 8
    bands, 30% binaries, 16 mass ratios, upsample 4; `sets` overrides
    keys) on a cluster simulated at the config's starting values.
    Returns (model, truth)."""
    import jax
    import jax.numpy as jnp

    from base_tpu.grids.load import load_ms_grid
    from base_tpu.io.settings import load_settings
    from base_tpu.model import posterior as post
    from base_tpu.model.stardata import make_ms_stars
    from base_tpu.sim.scatter import scatter_cluster
    from base_tpu.sim.simulate import simulate_cluster

    s = load_settings(str(CONF), list(sets))
    grid = load_ms_grid(s)
    truth = s.cluster.start_vector()
    cat = simulate_cluster(
        grid, jnp.asarray(truth), n_stars, jax.random.PRNGKey(seed),
        percent_binary=s.simCluster.percentBinary,
        min_mass=s.simCluster.minMass,
    )
    sc = scatter_cluster(
        cat.mags, jax.random.PRNGKey(seed + 1),
        limit_mag=s.scatterCluster.limitMag,
        sigma_floor=s.scatterCluster.sigmaFloor,
        relevant_filt=s.scatterCluster.relevantFilt,
    )
    mags = np.asarray(sc.mags)
    stars = make_ms_stars(
        mags, np.asarray(sc.sigmas),
        field_mag_range=s.cluster.field_mag_range_array(mags.shape[1]),
    )
    model = post.make_single_pop_model(
        grid, stars,
        prior_mean=s.cluster.prior_mean_vector(),
        prior_sigma=s.cluster.prior_sigma_vector(),
        n_q=s.mcmc.nMassRatio,
        binaries=not s.mcmc.noBinaries,
        upsample=s.mcmc.upsample,
    )
    return model, truth


def jittered(truth, n: int, scale: float, seed: int):
    rng = np.random.default_rng(seed)
    return (truth[None, :] + scale * rng.standard_normal((n, truth.size))
            * FREE[None, :]).astype(np.float32)


def check_kernel_parity(model, truth, n_tables: int = N_CHAINS,
                        interpret: bool = False, tiles=None) -> dict:
    """Fused kernel vs likelihood.ms_star_log_marginals on n_tables
    segment tables: forward max |diff| <= 5e-2 nats where the reference
    is above -200 (erf polynomial against the same polynomial, summed in
    another order and tiling), gradients w.r.t. lo, hi and logw within
    5e-3 of the largest component (analytic moments against autodiff)."""
    import jax
    import jax.numpy as jnp

    from base_tpu.model import likelihood as lk
    from base_tpu.model import posterior as post
    from base_tpu.ops.pallas_marglik import TILES, fused_log_marginals

    st = model.stars
    tiles = tiles or TILES
    params = jnp.asarray(jittered(truth, n_tables, 0.02, seed=1))
    tabs = jax.jit(jax.vmap(lambda p: post.segment_table(model, p)[0]))(params)
    mask = tabs.mask

    def fused(lo, hi, logw, m):
        return fused_log_marginals(st.obs_mags, st.inv_var, st.log_norm,
                                   lo, hi, logw, m.astype(jnp.float32),
                                   interpret=interpret, tiles=tiles)

    def plain(lo, hi, logw, m):
        return lk.ms_star_log_marginals(st, lk.SegmentTable(lo, hi, logw, m))

    g = jnp.asarray(np.random.default_rng(2).standard_normal(
        (n_tables, st.obs_mags.shape[0])).astype(np.float32))
    res = {}
    for name, f in (("fused", fused), ("plain", plain)):
        vf = jax.vmap(f)

        def loss(lo, hi, logw, vf=vf):
            return jnp.sum(vf(lo, hi, logw, mask) * g)

        out = jax.jit(vf)(tabs.lo, tabs.hi, tabs.logw, mask)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            tabs.lo, tabs.hi, tabs.logw)
        res[name] = (np.asarray(out), [np.asarray(x) for x in grads])
    want, want_g = res["plain"]
    got, got_g = res["fused"]
    sel = want > -200
    if sel.sum() < want.size // 2:
        raise AssertionError(f"only {sel.sum()} of {want.size} marginals "
                             f"above -200: not a realistic test point")
    fwd_err = float(np.abs(got[sel] - want[sel]).max())
    grad_err = {}
    for name, w, gt in zip(("lo", "hi", "logw"), want_g, got_g):
        if not (np.isfinite(gt).all() and np.isfinite(w).all()):
            raise AssertionError(f"non-finite gradient d/d{name}")
        grad_err[name] = float(np.abs(gt - w).max() / (np.abs(w).max() + 1e-6))
    out = {"S": int(st.obs_mags.shape[0]), "T": int(tabs.lo.shape[1]),
           "B": int(tabs.lo.shape[2]), "tables": n_tables,
           "fwd_max_abs_err": fwd_err, "grad_scaled_err": grad_err}
    print("  kernel parity:", json.dumps(out), flush=True)
    if fwd_err > 5e-2:
        raise AssertionError(f"forward max |diff| {fwd_err} > 5e-2")
    bad = {k: v for k, v in grad_err.items() if v > 5e-3}
    if bad:
        raise AssertionError(f"gradient scaled error > 5e-3: {bad}")
    return out


# Two compilations of the same float32 density differ by up to ~3e-5 of
# log_post and ~1.3e-3 of the largest gradient component, even on one
# CPU (vmapped against per-point, measured at 24 stars): d loglik / d mag
# ~ residual / sigma^2 ~ 1e2-1e4, so magnitude rounding (~1e-6 mag) that
# fusion or summation order moves shows up at that level.  The bounds
# below sit above that floor; TF32 anywhere (~1e-3 relative on the
# magnitudes, ~0.02 mag) would move log_post by O(10%).
LOGPOST_RTOL = 1e-4
GRAD_SCALED_TOL = 1e-2


def check_precision(model, truth, n_points: int = N_CHAINS) -> dict:
    """log_post and its gradient at n_points on the default device and on
    the CPU, within LOGPOST_RTOL and GRAD_SCALED_TOL (of each point's
    largest component).  The GPU side runs the fused kernel."""
    import jax

    from base_tpu.model import posterior as post

    tr = post.default_transform(model)
    z = jax.vmap(tr.inverse)(jittered(truth, n_points, 0.02, seed=3))

    def vg(m, t, zz):
        return jax.vmap(jax.value_and_grad(post.make_logpost_z_fn(m, t)))(zz)

    lp, g = jax.jit(vg)(model, tr, z)
    cpu = jax.devices("cpu")[0]
    lp_c, g_c = jax.jit(vg)(*jax.device_put((model, tr, z), cpu))
    lp, g, lp_c, g_c = map(np.asarray, (lp, g, lp_c, g_c))
    if not (np.isfinite(lp).all() and np.isfinite(g).all()):
        raise AssertionError("non-finite log_post or gradient")
    lp_errs = np.abs(lp - lp_c) / np.abs(lp_c)
    g_errs = np.abs(g - g_c).max(axis=1) / np.abs(g_c).max(axis=1)
    lp_err, g_err = float(lp_errs.max()), float(g_errs.max())
    out = {"points": n_points, "logpost_rel_err": lp_err,
           "grad_scaled_err": g_err,
           "median": [float(np.median(lp_errs)), float(np.median(g_errs))]}
    print("  precision:", json.dumps(out), flush=True)
    if lp_err > LOGPOST_RTOL:
        raise AssertionError(f"log_post relative error {lp_err}")
    if g_err > GRAD_SCALED_TOL:
        raise AssertionError(f"gradient scaled error {g_err}")
    return out


def _cli(argv: list[str]) -> str:
    """Run the CLI in this process; echo and return its stdout."""
    from base_tpu.tools.main import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    return out


def run_cli(workdir: Path, name: str, sets: list[str],
            extra: tuple = ()) -> dict:
    """simulate -> scatter -> single-pop through the CLI at conf/base9.yaml
    plus `sets`; checks the .res rows and returns what it read."""
    from base_tpu.grids.load import load_ms_grid
    from base_tpu.io import phot as photio
    from base_tpu.io import res as resio
    from base_tpu.io.settings import load_settings

    base = ["--config", str(CONF), "--outputFileBase", str(workdir / name)]
    for kv in sets:
        base += ["--set", kv]
    _cli(["simulate"] + base)
    _cli(["scatter"] + base + ["--photFile", str(workdir / f"{name}.sim.phot")])
    table = photio.read_phot(str(workdir / f"{name}.phot"))
    out = _cli(["single-pop"] + base + list(extra)
               + ["--photFile", str(workdir / f"{name}.phot")])
    chain = resio.read_res(str(workdir / f"{name}.res"))
    if not (np.isfinite(chain.params).all()
            and np.isfinite(chain.logpost).all()):
        raise AssertionError(f"{name}: non-finite .res rows")
    accept = float(re.search(r"accept=([-0-9.]+)", out).group(1))
    age = load_ms_grid(load_settings(str(CONF), sets)).age
    ages = chain.params[:, 0]
    if not (ages.min() >= float(age[0]) and ages.max() <= float(age[-1])):
        raise AssertionError(
            f"{name}: sampled age [{ages.min()}, {ages.max()}] outside the "
            f"prior hull [{float(age[0])}, {float(age[-1])}]")
    return {"rows": int(chain.params.shape[0]), "accept": accept,
            "stages": table.stage}


def _hmc_sets(warmup: int, draws_per_chain: int, extra=()) -> list[str]:
    from base_tpu.io.settings import load_settings

    chains = load_settings(str(CONF), list(extra)).mcmc.chains
    return ["mcmc.sampler=hmc", f"mcmc.warmup={warmup}",
            f"mcmc.runIter={chains * draws_per_chain}", *extra]


def check_cli_config1(workdir: Path, warmup: int = 160,
                      draws_per_chain: int = 64, extra=()) -> dict:
    """Phase 4: the shipped defaults (plus `extra` overrides) through the
    CLI; acceptance in (0.5, 0.99); the chunk program's compiled memory
    and the device's peak memory are printed."""
    import jax

    sets = _hmc_sets(warmup, draws_per_chain, extra)
    r = run_cli(workdir, "c1", sets)
    if not 0.5 < r["accept"] < 0.99:
        raise AssertionError(f"acceptance {r['accept']} outside (0.5, 0.99)")
    print("  chunk program memory:", chunk_memory(workdir / "c1.phot", sets))
    stats = jax.devices()[0].memory_stats() or {}
    print("  peak_bytes_in_use:", stats.get("peak_bytes_in_use"), flush=True)
    return {"rows": r["rows"], "accept": r["accept"]}


def chunk_memory(phot: Path, sets: list[str]):
    """compiled.memory_analysis() of the CLI's HMC sampling-chunk program
    for this photometry (compiled again here; the persistent cache
    usually serves it)."""
    import jax
    import jax.numpy as jnp

    from base_tpu.inference import hmc
    from base_tpu.io import phot as photio
    from base_tpu.io.settings import load_settings
    from base_tpu.model import posterior as post
    from base_tpu.tools.main import _build_model_from_phot

    s = load_settings(str(CONF), sets)
    model = _build_model_from_phot(s, photio.read_phot(str(phot)))
    cfg = hmc.HMCConfig(
        n_warmup=s.mcmc.warmup, n_samples=s.mcmc.runIter // s.mcmc.chains,
        l_max=s.mcmc.lMax, target_accept=s.mcmc.targetAccept,
        dense_mass=s.mcmc.denseMass, free_mask=post.free_mask(model),
    )
    fz = post.make_logpost_z_fn(model, post.default_transform(model))
    z = jnp.zeros((s.mcmc.chains, 9), jnp.float32)
    states = jax.eval_shape(
        lambda zz: hmc.init_chains(fz, zz, jax.random.PRNGKey(0), cfg), z)
    chunk = jax.jit(lambda st, im, e: hmc.sample_chunk(
        fz, st, im, e, cfg.n_samples, cfg))
    compiled = chunk.lower(
        states, jax.ShapeDtypeStruct((9, 9), jnp.float32),
        jax.ShapeDtypeStruct((), jnp.float32)).compile()
    return compiled.memory_analysis()


def check_cli_wd(workdir: Path, warmup: int = 64,
                 draws_per_chain: int = 16, extra=()) -> dict:
    """Phase 5: an older cluster (log age 9.5) whose photometry holds white
    dwarfs, so single-pop runs the WD branch."""
    from base_tpu import constants as C

    sets = _hmc_sets(warmup, draws_per_chain,
                     ("cluster.starting_logAge=9.5", *extra))
    r = run_cli(workdir, "wd", sets)
    n_wd = int((r["stages"] == C.StarStatus.WD).sum())
    if n_wd == 0:
        raise AssertionError("the WD cluster holds no white dwarfs")
    print(f"  white dwarfs: {n_wd}, accept={r['accept']:.3f}", flush=True)
    return {"rows": r["rows"], "accept": r["accept"], "wds": n_wd}


class _Stop(Exception):
    pass


def check_resume(model, truth, workdir: Path, chunk: int = 8,
                 n_chunks: int = 3, warmup: int = 32, l_max: int = 48,
                 n_chains: int = N_CHAINS) -> dict:
    """Phase 6: a checkpointed run stopped after chunk 0 (a streaming hook
    raises) and resumed equals an uninterrupted run bit for bit."""
    import jax
    import jax.numpy as jnp

    from base_tpu.inference import hmc
    from base_tpu.inference.driver import DriverConfig, run_hmc_checkpointed
    from base_tpu.model import posterior as post

    tr = post.default_transform(model)
    fz = post.make_logpost_z_fn(model, tr)
    cfg = hmc.HMCConfig(n_warmup=warmup, n_samples=chunk * n_chunks,
                        l_max=l_max, dense_mass=True, n_windows=2,
                        free_mask=post.free_mask(model))
    init = jax.vmap(tr.inverse)(jittered(truth, n_chains, 0.01, seed=4))
    key = jax.random.PRNGKey(5)
    want, _ = run_hmc_checkpointed(fz, init, key, cfg,
                                   DriverConfig(chunk_size=chunk))

    def stop(ci, zs, lps):
        if ci == 0:
            raise _Stop

    path = str(workdir / "resume.ckpt")
    try:
        run_hmc_checkpointed(fz, init, key, cfg, DriverConfig(
            checkpoint_path=path, chunk_size=chunk, on_window=stop))
        raise AssertionError("the run was not stopped")
    except _Stop:
        pass
    got, _ = run_hmc_checkpointed(fz, init, key, cfg, DriverConfig(
        checkpoint_path=path, chunk_size=chunk))
    want, got = np.asarray(want), np.asarray(got)
    same = bool(np.array_equal(want, got))
    diff = float(np.abs(want - got).max()) if not same else 0.0
    out = {"draws": int(want.shape[0]), "bit_identical": same,
           "max_abs_diff": diff, "finite": bool(np.isfinite(got).all())}
    print("  resume:", json.dumps(out), flush=True)
    if not same:
        first = int(np.argmax(np.any(want != got, axis=(1, 2))))
        raise AssertionError(
            f"resumed run differs from the uninterrupted one from draw "
            f"{first} (max |diff| {diff})")
    return out


def check_sharded(model, truth, mesh_shape=(2, 2),
                  n_points: int = N_CHAINS) -> dict:
    """Sharded log_post and gradient on a (chains x stars) mesh against
    one device, within LOGPOST_RTOL and GRAD_SCALED_TOL: the sharded
    program is another compilation of the same float32 density (the
    psum's reordering alone is ~1e-7).  Checks that every device holds
    its shard of the star data."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from base_tpu.model import posterior as post
    from base_tpu.parallel import run as prun
    from base_tpu.parallel.mesh import CHAIN_AXIS, STAR_AXIS, make_mesh

    mesh = make_mesh(n_chain_shards=mesh_shape[0], n_star_shards=mesh_shape[1])
    tr = post.default_transform(model)
    z = jax.vmap(tr.inverse)(jittered(truth, n_points, 0.02, seed=6))
    want_lp, want_g = jax.jit(jax.vmap(jax.value_and_grad(
        post.make_logpost_z_fn(model, tr))))(z)

    frame, stars, _ = prun._split_frame(model, mesh)

    def device_fn(stars_local, zz):
        f = prun.local_logpost_fn(frame, stars_local, STAR_AXIS)
        return jax.vmap(jax.value_and_grad(
            lambda u: f(tr.forward(u)) + tr.log_det_jacobian(u)))(zz)

    fn = jax.jit(jax.shard_map(
        device_fn, mesh=mesh,
        in_specs=(prun._star_specs(stars), P(CHAIN_AXIS)),
        out_specs=(P(CHAIN_AXIS), P(CHAIN_AXIS)), check_vma=True,
    ))
    lp, g = fn(stars, z)
    holders = {s.device for s in stars.obs_mags.addressable_shards}
    if holders != set(mesh.devices.flat):
        raise AssertionError(f"star shards on {holders}, mesh has "
                             f"{set(mesh.devices.flat)}")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in mesh.devices.flat]
    lp, g, want_lp, want_g = map(np.asarray, (lp, g, want_lp, want_g))
    lp_err = float(np.max(np.abs(lp - want_lp) / np.abs(want_lp)))
    g_err = float(np.max(np.abs(g - want_g).max(axis=1)
                         / np.abs(want_g).max(axis=1)))
    out = {"mesh": list(mesh_shape), "logpost_rel_err": lp_err,
           "grad_scaled_err": g_err, "peak_bytes_in_use": peaks}
    print("  sharded:", json.dumps(out), flush=True)
    if lp_err > LOGPOST_RTOL:
        raise AssertionError(f"sharded log_post relative error {lp_err}")
    if g_err > GRAD_SCALED_TOL:
        raise AssertionError(f"sharded gradient scaled error {g_err}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded path only")
    args = ap.parse_args(argv)

    from base_tpu import platform

    info = platform.require_gpu()
    platform.setup_compile_cache()
    with phase("device"):
        print("  device:", json.dumps(info))
        print("  card:", card_line(), flush=True)
    if args.four and info["count"] < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {info['count']}")
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        model, truth = config1_model()
        if args.four:
            with phase("sharded log_post 2x2"):
                check_sharded(model, truth)
            with phase("cli single-pop --mesh 2,2"):
                r = run_cli(workdir, "mesh", _hmc_sets(64, 16),
                            extra=("--mesh", "2,2"))
                print(f"  rows={r['rows']} accept={r['accept']:.3f}")
        else:
            with phase("kernel parity"):
                check_kernel_parity(model, truth)
            with phase("precision gpu vs cpu"):
                check_precision(model, truth)
            with phase("cli config 1"):
                check_cli_config1(workdir)
            with phase("cli white dwarfs"):
                check_cli_wd(workdir)
            with phase("resume"):
                check_resume(model, truth, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
