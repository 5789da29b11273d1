"""No-U-Turn Sampler: iterative multinomial NUTS, static shapes.

Required by the north star (BASELINE.json:5 "NUTS/HMC"); the reference
has nothing gradient-based.  Design choices for an accelerator:

- *Iterative* tree building (no recursion): one `lax.while_loop` per
  doubling, one inner `lax.while_loop` over the subtree's leapfrog
  leaves.  All buffers are static; the only dynamism is loop trip count.
- Sub-U-turn checks use a checkpoint stack: leaf s is stored at slot j
  whenever s % 2^j == 0 (it opens a 2^j block), and leaf i is checked
  against slot j whenever (i+1) % 2^j == 0 (it closes that block) — the
  complete-balanced-subtree criterion with max_depth slots, O(max_depth)
  selects per leaf, no O(2^d) state storage.
- Progressive multinomial sampling within and across subtrees (Stan
  semantics: biased doubling acceptance min(1, W_new/W_old)).
- Under vmap, chains run in lockstep to the slowest tree; for raw
  throughput-per-chip with many chains, jittered-trajectory HMC
  (inference.hmc) remains the recommended mode — NUTS is the robustness
  mode (no l_max tuning, adapts trajectory length per region).

Dual averaging + windowed mass adaptation reuse inference.hmc's
machinery; run_nuts mirrors run_hmc's interface.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from base_tpu.inference.hmc import (
    DAState,
    da_init,
    da_update,
    _kinetic,
    _mass_matvec,
    _metric_chol,
    _sample_momentum,
    _vmap_chains,
    _window_update,
)
from base_tpu.ops.special import NEG_INF
from base_tpu.utils.vma import vma_like


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    n_warmup: int = 500
    n_samples: int = 1000
    thin: int = 1
    max_depth: int = 8
    target_accept: float = 0.8
    init_step: float = 0.05
    n_windows: int = 4
    max_delta_energy: float = 1000.0
    # Same semantics as HMCConfig: full [P,P] metric from the pooled
    # cross-chain covariance (the age-FeH-mod ridge defeats a diagonal
    # one), and pinned density-flat dims.
    dense_mass: bool = False
    free_mask: tuple | None = None
    # Max chains evaluated concurrently inside one device's vmap (same
    # memory-bounding semantics as HMCConfig.chain_chunk: chain blocks
    # run sequentially under lax.map, peak memory is one block's).
    chain_chunk: int | None = None

    def mask_array(self, P: int) -> Array:
        if self.free_mask is None:
            return jnp.ones((P,), jnp.float32)
        return jnp.asarray(self.free_mask, jnp.float32)


class _Point(NamedTuple):
    z: Array
    p: Array
    grad: Array
    lp: Array


class NUTSChainState(NamedTuple):
    z: Array
    logpost: Array
    grad: Array
    key: Array
    da: DAState


def _uturn(z_a, p_a, z_b, p_b, inv_mass) -> Array:
    """U-turn between ordered endpoints a (left) and b (right)."""
    dz = z_b - z_a
    hi = jax.lax.Precision.HIGHEST
    return (jnp.dot(dz, _mass_matvec(inv_mass, p_a), precision=hi) < 0.0) | (
        jnp.dot(dz, _mass_matvec(inv_mass, p_b), precision=hi) < 0.0
    )


def _leapfrog_one(vgrad, pt: _Point, eps, inv_mass, direction,
                  mask=None) -> _Point:
    e = eps * direction
    p_half = pt.p + 0.5 * e * pt.grad
    z_new = pt.z + e * _mass_matvec(inv_mass, p_half)
    lp, g = vgrad(z_new)
    if mask is not None:
        g = g * mask
    p_new = p_half + 0.5 * e * g
    return _Point(z=z_new, p=p_new, grad=g, lp=lp)


def nuts_transition(
    vgrad: Callable,
    state: NUTSChainState,
    eps: Array,
    inv_mass: Array,
    cfg: NUTSConfig,
    chol: Array | None = None,
):
    """One NUTS update.  Returns (state, accept_stat, n_leapfrog).

    `chol` is the precomputed factor of inv_mass (hmc._metric_chol);
    passing it keeps the factorization out of scan bodies."""
    P = state.z.shape[0]
    D = cfg.max_depth
    mask = cfg.mask_array(P)
    if chol is None:
        chol = _metric_chol(inv_mass)
    key, k_mom = jax.random.split(state.key)
    p0 = _sample_momentum(k_mom, chol, P) * mask
    ke0 = _kinetic(inv_mass, p0)
    h0 = -state.logpost + ke0  # energy at start

    init_pt = _Point(z=state.z, p=p0, grad=state.grad * mask,
                     lp=state.logpost)

    def energy(pt: _Point) -> Array:
        return -pt.lp + _kinetic(inv_mass, pt.p)

    # Tree carry --------------------------------------------------------
    # proposal: progressively-sampled point; logw: multinomial weight of
    # the whole tree; left/right: tree endpoints; sum_acc/n_acc: mean
    # accept-prob statistic for dual averaging.
    class Carry(NamedTuple):
        key: Array
        depth: Array
        prop_z: Array
        prop_lp: Array
        prop_grad: Array
        logw: Array
        left: _Point
        right: _Point
        done: Array
        sum_acc: Array
        n_lf: Array

    def _v(x):
        # constant-initialized loop carries must enter with their
        # steady-state vma under shard_map(check_vma=True); no-op
        # unsharded (see utils/vma.py)
        return vma_like(x, state.logpost)

    carry = Carry(
        key=key,
        depth=_v(jnp.zeros((), jnp.int32)),
        prop_z=state.z,
        prop_lp=state.logpost,
        prop_grad=state.grad,
        logw=_v(jnp.zeros(())),  # weights measured relative to exp(-h0)
        left=init_pt,
        right=init_pt,
        done=_v(jnp.zeros((), bool)),
        sum_acc=_v(jnp.zeros(())),
        n_lf=_v(jnp.zeros((), jnp.int32)),
    )

    def build_subtree(key, frontier: _Point, direction, n_leaves):
        """Take up to n_leaves leapfrog steps from `frontier`; returns
        (new frontier, subtree proposal, subtree logw, turning,
        diverging, sum_acc, n_done)."""
        ck_z = jnp.zeros((D, P))
        ck_p = jnp.zeros((D, P))

        class SC(NamedTuple):
            key: Array
            i: Array
            pt: _Point
            prop_z: Array
            prop_lp: Array
            prop_grad: Array
            logw: Array
            ck_z: Array
            ck_p: Array
            turning: Array
            diverging: Array
            sum_acc: Array

        sc = SC(
            key=key,
            i=_v(jnp.zeros((), jnp.int32)),
            pt=frontier,
            prop_z=frontier.z,
            prop_lp=frontier.lp,
            prop_grad=frontier.grad,
            logw=_v(jnp.asarray(-jnp.inf)),
            ck_z=_v(ck_z),
            ck_p=_v(ck_p),
            turning=_v(jnp.zeros((), bool)),
            diverging=_v(jnp.zeros((), bool)),
            sum_acc=_v(jnp.zeros(())),
        )

        def sc_cond(sc: SC):
            return (sc.i < n_leaves) & ~sc.turning & ~sc.diverging

        def sc_body(sc: SC):
            key, k_sel = jax.random.split(sc.key)
            pt = _leapfrog_one(vgrad, sc.pt, eps, inv_mass, direction,
                               mask=mask)
            h = energy(pt)
            h = jnp.where(jnp.isfinite(h), h, jnp.inf)
            dh = h - h0
            diverging = dh > cfg.max_delta_energy
            w = -dh  # log weight relative to start energy
            acc = jnp.minimum(1.0, jnp.exp(jnp.minimum(-dh, 0.0)))

            # progressive within-subtree sampling
            logw_new = jnp.logaddexp(sc.logw, w)
            take = jnp.log(jax.random.uniform(k_sel, ())) < (w - logw_new)
            prop_z = jnp.where(take, pt.z, sc.prop_z)
            prop_lp = jnp.where(take, pt.lp, sc.prop_lp)
            prop_grad = jnp.where(take, pt.grad, sc.prop_grad)

            s = sc.i  # leaf index within subtree, 0-based
            ck_z, ck_p = sc.ck_z, sc.ck_p
            turning = sc.turning
            for j in range(1, D + 1):
                opens = (s % (2 ** j)) == 0
                ck_z = jnp.where(opens, ck_z.at[j - 1].set(pt.z), ck_z)
                ck_p = jnp.where(opens, ck_p.at[j - 1].set(pt.p), ck_p)
                closes = ((s + 1) % (2 ** j)) == 0
                # endpoints ordered along integration direction
                tj = jnp.where(
                    direction > 0,
                    _uturn(ck_z[j - 1], ck_p[j - 1], pt.z, pt.p, inv_mass),
                    _uturn(pt.z, pt.p, ck_z[j - 1], ck_p[j - 1], inv_mass),
                )
                turning = turning | (closes & tj)

            return SC(
                key=key,
                i=sc.i + 1,
                pt=pt,
                prop_z=prop_z,
                prop_lp=prop_lp,
                prop_grad=prop_grad,
                logw=logw_new,
                ck_z=ck_z,
                ck_p=ck_p,
                turning=turning,
                diverging=diverging,
                sum_acc=sc.sum_acc + acc,
            )

        sc = jax.lax.while_loop(sc_cond, sc_body, sc)
        return sc

    def cond(c: Carry):
        return (c.depth < D) & ~c.done

    def body(c: Carry):
        key, k_dir, k_sub, k_acc = jax.random.split(c.key, 4)
        direction = jnp.where(
            jax.random.bernoulli(k_dir), 1.0, -1.0
        )
        frontier = jax.tree_util.tree_map(
            lambda l, r: jnp.where(direction > 0, r, l), c.left, c.right
        )
        n_leaves = jnp.left_shift(jnp.ones((), jnp.int32), c.depth)
        sc = build_subtree(k_sub, frontier, direction, n_leaves)

        bad = sc.turning | sc.diverging
        # Stan's biased progressive doubling: accept the subtree's
        # proposal with prob min(1, W_sub / W_tree_old).
        take = jnp.log(jax.random.uniform(k_acc, ())) < (sc.logw - c.logw)
        take = take & ~bad
        prop_z = jnp.where(take, sc.prop_z, c.prop_z)
        prop_lp = jnp.where(take, sc.prop_lp, c.prop_lp)
        prop_grad = jnp.where(take, sc.prop_grad, c.prop_grad)
        logw = jnp.where(bad, c.logw, jnp.logaddexp(c.logw, sc.logw))

        new_left = jax.tree_util.tree_map(
            lambda cur, new: jnp.where((direction < 0) & ~bad, new, cur),
            c.left, sc.pt,
        )
        new_right = jax.tree_util.tree_map(
            lambda cur, new: jnp.where((direction > 0) & ~bad, new, cur),
            c.right, sc.pt,
        )
        turning_total = _uturn(
            new_left.z, new_left.p, new_right.z, new_right.p, inv_mass
        )
        return Carry(
            key=key,
            depth=c.depth + 1,
            prop_z=prop_z,
            prop_lp=prop_lp,
            prop_grad=prop_grad,
            logw=logw,
            left=new_left,
            right=new_right,
            done=bad | turning_total,
            sum_acc=c.sum_acc + sc.sum_acc,
            n_lf=c.n_lf + sc.i,
        )

    out = jax.lax.while_loop(cond, body, carry)
    accept_stat = out.sum_acc / jnp.maximum(out.n_lf.astype(jnp.float32), 1.0)
    ok = out.prop_lp > NEG_INF / 2
    new_state = NUTSChainState(
        z=jnp.where(ok, out.prop_z, state.z),
        logpost=jnp.where(ok, out.prop_lp, state.logpost),
        grad=jnp.where(ok, out.prop_grad, state.grad),
        key=key,
        da=state.da,
    )
    return new_state, accept_stat, out.n_lf


def init_nuts_chains(
    logpost_fn: Callable, init_z: Array, key: Array, cfg: NUTSConfig
) -> NUTSChainState:
    """Initial per-chain state batch (vmapped leaves, leading axis C)."""
    C, _ = init_z.shape
    vgrad = jax.value_and_grad(logpost_fn)
    keys = jax.random.split(key, C)
    lp0, g0 = jax.vmap(vgrad)(init_z)
    return NUTSChainState(
        z=init_z, logpost=lp0, grad=g0, key=keys,
        da=jax.tree_util.tree_map(
            # constant-initialized DA state must enter the warmup scan
            # with its steady-state vma (see utils/vma.py); no-op unsharded
            lambda x: vma_like(x, lp0),
            jax.vmap(lambda _: da_init(cfg.init_step))(jnp.arange(C)),
        ),
    )


def make_nuts_warmup_window(
    logpost_fn: Callable,
    cfg: NUTSConfig,
    axis_name: str | None = None,
) -> Callable:
    """One warmup window as a standalone jittable
    `(states, inv_mass, w) -> (states, inv_mass)` — the NUTS analog of
    hmc.make_warmup_window (same schedule, shared _window_update), for
    host-chunked execution."""
    vgrad = jax.value_and_grad(logpost_fn)
    seg_len = max(cfg.n_warmup // cfg.n_windows, 1)

    def window_fn(states, inv_mass, w):
        P = states.z.shape[-1]
        mask = cfg.mask_array(P)
        chol = _metric_chol(inv_mass)  # once per window, not per step

        def one_chain(st):
            def body(st, _):
                eps = jnp.exp(st.da.log_eps)
                st2, acc, _ = nuts_transition(vgrad, st, eps, inv_mass,
                                              cfg, chol=chol)
                st2 = st2._replace(
                    da=da_update(st2.da, acc, cfg.target_accept)
                )
                return st2, st2.z

            return jax.lax.scan(body, st, None, length=seg_len)

        states, zs = _vmap_chains(one_chain, states, cfg.chain_chunk)
        return _window_update(states, inv_mass, zs, w, cfg, mask,
                              axis_name)

    return window_fn


def nuts_sample_chunk(
    logpost_fn: Callable,
    states: NUTSChainState,
    inv_mass: Array,
    eps: Array,
    n_record: int,
    cfg: NUTSConfig,
):
    """Record `n_record` thinned draws from every chain.  Returns
    (states, zs [C, n, P], lps [C, n], accs [C, n], nlfs [C, n])."""
    vgrad = jax.value_and_grad(logpost_fn)
    chol = _metric_chol(inv_mass)  # frozen metric: factor once

    def one_chain(st):
        def body(st, _):
            def inner(s, _):
                s2, acc, nlf = nuts_transition(
                    vgrad, s, eps, inv_mass, cfg, chol=chol
                )
                return s2, (acc, nlf)

            st, (accs, nlfs) = jax.lax.scan(inner, st, None, length=cfg.thin)
            return st, (st.z, st.logpost, jnp.mean(accs), jnp.sum(nlfs))

        return jax.lax.scan(body, st, None, length=n_record)

    return _vmap_chains(one_chain, states, cfg.chain_chunk)


def run_nuts(
    logpost_fn: Callable,
    init_z: Array,   # [C, P]
    key: Array,
    cfg: NUTSConfig = NUTSConfig(),
    axis_name: str | None = None,
):
    """Warmup (dual averaging + pooled mass windows) + sampling, NUTS
    kernel.  Same interface/contract as hmc.run_hmc."""
    C, P = init_z.shape
    states = init_nuts_chains(logpost_fn, init_z, key, cfg)
    window_fn = make_nuts_warmup_window(logpost_fn, cfg, axis_name)

    # Windows as a lax.scan, not a Python unroll — each unrolled window
    # duplicates the whole NUTS tree program in the HLO.
    def window(carry, w):
        states, inv_mass = carry
        states, inv_mass = window_fn(states, inv_mass, w)
        return (states, inv_mass), None

    inv_mass0 = jnp.eye(P) if cfg.dense_mass else jnp.ones((P,))
    (states, inv_mass), _ = jax.lax.scan(
        window, (states, inv_mass0), jnp.arange(cfg.n_windows)
    )

    le = jnp.mean(states.da.log_eps_avg)
    if axis_name is not None:
        le = jax.lax.pmean(le, axis_name)
    eps_final = jnp.exp(le)

    states, (zs, lps, accs, nlfs) = nuts_sample_chunk(
        logpost_fn, states, inv_mass, eps_final,
        cfg.n_samples // cfg.thin, cfg,
    )
    samples = jnp.swapaxes(zs, 0, 1)
    info = dict(
        accept_prob=jnp.mean(accs),
        step_size=eps_final,
        inv_mass=inv_mass,
        logposts=jnp.swapaxes(lps, 0, 1),
        mean_leapfrogs=jnp.mean(nlfs.astype(jnp.float32)),
        final_states=states,
    )
    return samples, info


def make_nuts_chunked_runner(
    logpost_fn: Callable,
    cfg: NUTSConfig,
    chunk_draws: int = 128,
) -> Callable:
    """Host-chunked NUTS (the hmc.make_hmc_chunked_runner analog): one
    device execution per warmup window + bounded sampling chunks, so the
    host sees every chunk boundary.  NUTS chunks default smaller than
    HMC's — each draw costs up to
    2^max_depth leapfrogs.  Returns run(init_z, key, n_samples=None)."""
    win = jax.jit(make_nuts_warmup_window(logpost_fn, cfg))
    init_fn = jax.jit(
        lambda z, k: init_nuts_chains(logpost_fn, z, k, cfg)
    )
    chunk = max(min(chunk_draws, cfg.n_samples // cfg.thin), 1)
    step = jax.jit(
        lambda st, im, e: nuts_sample_chunk(
            logpost_fn, st, im, e, chunk, cfg
        )
    )

    def run(init_z: Array, key: Array, n_samples: int | None = None):
        P = init_z.shape[-1]
        inv_mass = jnp.eye(P) if cfg.dense_mass else jnp.ones((P,))
        states = init_fn(init_z, key)
        for w in range(cfg.n_windows):
            states, inv_mass = win(states, inv_mass, jnp.asarray(w))
        le = jnp.mean(states.da.log_eps_avg)
        eps = jnp.exp(le)

        n_rec = (cfg.n_samples if n_samples is None else n_samples) // cfg.thin
        n_chunks = (n_rec + chunk - 1) // chunk
        zs_all, lps_all, acc_all, nlf_all = [], [], [], []
        for _ in range(n_chunks):
            states, (zs, lps, accs, nlfs) = step(states, inv_mass, eps)
            zs_all.append(jnp.swapaxes(zs, 0, 1))
            lps_all.append(jnp.swapaxes(lps, 0, 1))
            acc_all.append(jnp.swapaxes(accs, 0, 1))   # [n, C]
            nlf_all.append(jnp.swapaxes(nlfs, 0, 1).astype(jnp.float32))
        samples = jnp.concatenate(zs_all, axis=0)[:n_rec]
        info = dict(
            # Weighted by recorded draws (over-run draws of an uneven
            # last chunk excluded) — same policy as the HMC runner.
            accept_prob=jnp.mean(jnp.concatenate(acc_all, axis=0)[:n_rec]),
            step_size=eps,
            inv_mass=inv_mass,
            logposts=jnp.concatenate(lps_all, axis=0)[:n_rec],
            mean_leapfrogs=jnp.mean(
                jnp.concatenate(nlf_all, axis=0)[:n_rec]
            ),
            final_states=states,
        )
        return samples, info

    return run
