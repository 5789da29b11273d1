"""Fused marginal kernel against the plain XLA path on one GPU.

    python scripts/kernel_ab.py --check     # compile + parity per tile set
    python scripts/kernel_ab.py             # sweep, end-to-end A/B, traces

Full mode, all in one process on one card:
  1. tile sweep: forward + gradient of the marginal alone, vmapped over
     64 segment tables at the shipped default widths, for each tile set
     and for the plain jnp marginal;
  2. end to end: an HMC sampling chunk (64 chains, l_max 48) of the full
     log_post value and gradient, plain and kernel in turns (plain,
     kernel, kernel, plain), at the shipped defaults (upsample 4, 16 mass
     ratios) and at bench.py's shape (64 EEPs, 8 mass ratios, upsample 1);
  3. a profiler trace of two chunks per path at the shipped defaults,
     reduced to device time per named layer (isochrone, segment_table,
     marginal) and the device idle share.

Prints one JSON line per measurement and writes them, with the traces,
under chiprun_out/kernel_ab/.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "chiprun_out" / "kernel_ab"

import chip_smoke  # noqa: E402

CANDIDATES = {
    "s16_t64_p8_w4": dict(s=16, t=64, t_tiles_per_program=8, num_warps=4),
    "s16_t128_p4_w4": dict(s=16, t=128, t_tiles_per_program=4, num_warps=4),
    "s32_t64_p8_w4": dict(s=32, t=64, t_tiles_per_program=8, num_warps=4),
    "s32_t128_p4_w8": dict(s=32, t=128, t_tiles_per_program=4, num_warps=8),
    "s16_t64_p8_w2": dict(s=16, t=64, t_tiles_per_program=8, num_warps=2),
    "s16_t64_p16_w4": dict(s=16, t=64, t_tiles_per_program=16, num_warps=4),
    "s8_t128_p8_w4": dict(s=8, t=128, t_tiles_per_program=8, num_warps=4),
}
BENCH_SETS = ("mcmc.upsample=1", "mcmc.nMassRatio=8")


def emit(rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    with open(OUT / "results.jsonl", "a") as f:
        f.write(line + "\n")


def timed(fn, *args, reps: int = 10) -> dict:
    import jax

    jax.block_until_ready(fn(*args))     # compile + warm
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(ts), "min_s": min(ts),
            "max_s": max(ts), "reps": reps}


def marginal_fns(model, truth, tiles, n_tables=64):
    """(tables, {name: jitted value-and-grad over the tables})."""
    import jax
    import jax.numpy as jnp

    from base_tpu.model import likelihood as lk
    from base_tpu.model import posterior as post
    from base_tpu.ops.pallas_marglik import fused_log_marginals

    st = model.stars
    params = jnp.asarray(chip_smoke.jittered(truth, n_tables, 0.02, seed=1))
    tabs = jax.jit(jax.vmap(lambda p: post.segment_table(model, p)[0]))(params)

    def make(one):
        def loss(lo, hi, logw):
            return jnp.sum(jax.vmap(one)(lo, hi, logw, tabs.mask))
        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))

    fns = {"plain": make(lambda lo, hi, lw, m: lk.ms_star_log_marginals(
        st, lk.SegmentTable(lo, hi, lw, m)))}
    for name, t in tiles.items():
        fns[name] = make(lambda lo, hi, lw, m, t=t: fused_log_marginals(
            st.obs_mags, st.inv_var, st.log_norm, lo, hi, lw,
            m.astype(jnp.float32), tiles=t))
    return tabs, fns


def use_path(path: str, tiles=None) -> None:
    """Route likelihood.ms_log_marginals to the plain jnp marginal or to
    the fused kernel (with `tiles`) for the next traces."""
    from base_tpu.model import likelihood as lk
    from base_tpu.ops.pallas_marglik import TILES, fused_log_marginals

    import jax.numpy as jnp

    if path == "plain":
        lk.ms_log_marginals = lk.ms_star_log_marginals
        return
    t = tiles or TILES
    lk.ms_log_marginals = lambda stars, table: fused_log_marginals(
        stars.obs_mags, stars.inv_var, stars.log_norm, table.lo, table.hi,
        table.logw, table.mask.astype(jnp.float32), tiles=t)


def chunk_runner(model, truth, n_chains=64, l_max=48, draws=4):
    """A jitted HMC sampling chunk over the full log_post, as the CLI's
    chunked runner compiles it, plus its arguments."""
    import jax
    import jax.numpy as jnp

    from base_tpu.inference import hmc
    from base_tpu.model import posterior as post

    tr = post.default_transform(model)
    fz = post.make_logpost_z_fn(model, tr)
    cfg = hmc.HMCConfig(n_warmup=0, n_samples=draws, l_max=l_max,
                        dense_mass=True, jitter_mode="step",
                        free_mask=post.free_mask(model))
    init = jax.vmap(tr.inverse)(
        chip_smoke.jittered(truth, n_chains, 0.01, seed=7))
    states = jax.jit(lambda z: hmc.init_chains(
        fz, z, jax.random.PRNGKey(0), cfg))(init)
    step = jax.jit(lambda s, im, e: hmc.sample_chunk(fz, s, im, e, draws, cfg))
    args = (states, jnp.eye(9) * 0.01, jnp.asarray(0.05, jnp.float32))
    return step, args, draws * l_max * n_chains


def scope_of_instructions(hlo_text: str) -> dict:
    """{HLO instruction name (and its kernel-name spelling): named scope}
    from a compiled module's text, via each instruction's op_name."""
    scopes = ("isochrone", "segment_table", "marginal", "wd_branch")
    out = {}
    pat = re.compile(r'^\s*(?:ROOT )?%?([\w.\-]+) = .*op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        hit = next((k for k in scopes if re.search(
            rf"(^|[/(]){k}($|[/)])", m.group(2))), None)
        if hit:
            out[m.group(1)] = hit
            out[re.sub(r"[.\-]", "_", m.group(1))] = hit
    return out


def layer_times(trace_dir: Path, scope_map: dict | None = None) -> dict:
    """Device time per named layer, device busy time and idle share from
    the newest trace under trace_dir.  Events are attributed through
    their hlo_op stat (or kernel name) and `scope_map`, else by a scope
    name in the event's own text."""
    import jax

    files = sorted(trace_dir.rglob("*.xplane.pb"), key=os.path.getmtime)
    pd = jax.profiler.ProfileData.from_file(str(files[-1]))
    scopes = ("isochrone", "segment_table", "marginal", "wd_branch")
    out = {k: 0.0 for k in scopes}
    out["other"] = 0.0
    spans, kernels = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        # Kernel events live on the per-stream lines; other lines are
        # summaries of the same time.
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                text = ev.name + " " + " ".join(
                    str(v) for _, v in ev.stats)
                dur = ev.duration_ns * 1e-9
                spans.append((ev.start_ns, ev.end_ns))
                stats = dict((k, str(v)) for k, v in ev.stats)
                hit = (scope_map or {}).get(stats.get("hlo_op", ""))
                hit = hit or (scope_map or {}).get(ev.name)
                if "marglik" in ev.name:
                    hit = "marginal"
                hit = hit or next((k for k in scopes if k in text), "other")
                out[hit] += dur
                kernels[ev.name] = kernels.get(ev.name, 0.0) + dur
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"layer_s": out, "busy_s": busy * 1e-9,
            "window_s": window * 1e-9,
            "idle_share": 1 - busy / window if window else None,
            "top_kernels_s": top, "trace_file": str(files[-1])}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--layers", action="store_true",
                    help="only the per-layer trace at the shipped defaults")
    args = ap.parse_args()

    import jax

    from base_tpu import platform
    from base_tpu.ops.pallas_marglik import Tiles

    info = platform.require_gpu()
    platform.setup_compile_cache()
    OUT.mkdir(parents=True, exist_ok=True)
    emit({"device": info, "card": chip_smoke.card_line()})
    tiles = {k: Tiles(**v) for k, v in CANDIDATES.items()}
    model, truth = chip_smoke.config1_model()

    if args.check:
        for name, t in tiles.items():
            try:
                r = chip_smoke.check_kernel_parity(model, truth, tiles=t)
                emit({"check": name, **r})
            except Exception as e:  # report every tile set, then fail
                emit({"check": name, "error": repr(e)[:2000]})
        return

    if args.layers:
        for path in ("plain", "kernel"):
            use_path(path)
            step, a, evals, = chunk_runner(model, truth)
            text = step.lower(*a).compile().as_text()
            (OUT / f"hlo_{path}.txt").write_text(text)
            jax.block_until_ready(step(*a))
            d = OUT / f"layers_{path}"
            with jax.profiler.trace(str(d)):
                for _ in range(2):
                    jax.block_until_ready(step(*a))
            r = layer_times(d, scope_of_instructions(text))
            r["leapfrog_steps"] = 2 * evals // 64
            emit({"layers": path, **r})
        return

    tabs, fns = marginal_fns(model, truth, tiles)
    for name, f in fns.items():
        try:
            r = timed(f, tabs.lo, tabs.hi, tabs.logw, reps=20)
            emit({"sweep": name, "T": int(tabs.lo.shape[1]), **r})
        except Exception as e:
            emit({"sweep": name, "error": repr(e)[:2000]})
    best = min((json.loads(x) for x in open(OUT / "results.jsonl")
                if '"sweep"' in x and "median_s" in x
                and '"plain"' not in x), key=lambda r: r["median_s"])
    best_tiles = tiles[best["sweep"]]
    emit({"best_tiles": best["sweep"]})

    for shape, sets in (("defaults", ()), ("bench", BENCH_SETS)):
        m, tru = chip_smoke.config1_model(sets=sets)
        runners = {}
        for path in ("plain", "kernel"):
            use_path(path, best_tiles)
            step, a, evals = chunk_runner(m, tru)
            t0 = time.perf_counter()
            jax.block_until_ready(step(*a))
            runners[path] = (step, a, evals, time.perf_counter() - t0)
        for path in ("plain", "kernel", "kernel", "plain"):
            step, a, evals, compile_s = runners[path]
            r = timed(step, *a, reps=5)
            emit({"e2e": shape, "path": path, "compile_s": compile_s,
                  "chain_grad_evals_per_s": evals / r["median_s"], **r})
        if shape == "defaults":
            for path in ("plain", "kernel"):
                step, a, _, _ = runners[path]
                d = OUT / f"trace_{path}"
                with jax.profiler.trace(str(d)):
                    for _ in range(2):
                        jax.block_until_ready(step(*a))
                emit({"trace": path, **layer_times(d)})
        stats = jax.devices()[0].memory_stats() or {}
        emit({"shape": shape,
              "peak_bytes_in_use": stats.get("peak_bytes_in_use")})


if __name__ == "__main__":
    main()
