"""HMC with dual-averaging step size and cross-chain mass adaptation.

The reference has no gradient sampler — adding one is the core of the
Vectorised design (BASELINE.json:5 requires NUTS/HMC; SURVEY.md §7
step 3).  Design:

- Leapfrog is a `lax.scan` over a randomly jittered number of steps
  (full `l_max` trajectory computed, state selected at the jittered
  length — static shapes, no host sync).
- Warmup runs as a static unrolled sequence of *windows*; inside each
  window every chain scans independently under `vmap`, and between
  windows the diagonal mass matrix is re-estimated from the POOLED
  cross-chain sample variance — many chains make short windows
  informative, which is exactly the chips-full-of-chains regime.
- Step size: Nesterov dual averaging per chain toward a target
  acceptance, then frozen at the across-chain mean of the DA average
  for sampling.
- `axis_name`: when chains are sharded over a mesh axis (shard_map),
  the pooled variance and frozen step size combine across devices with
  `psum` — the whole sampler then runs identically from 1 chip to a pod
  (SURVEY.md §2.4 chain-parallel = DP axis).

The function is fully traceable: wrap `run_hmc` in jit (single device)
or `shard_map` + jit (sharded chains).  Operates in unconstrained
space: pass the transformed density from posterior.make_logpost_z_fn.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from base_tpu.ops.special import NEG_INF


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    n_warmup: int = 500
    n_samples: int = 1000
    thin: int = 1
    l_max: int = 24              # max leapfrog steps per trajectory
    target_accept: float = 0.8
    init_step: float = 0.05
    n_windows: int = 4           # mass-matrix re-estimation points
    # Trajectory randomization (breaks periodic-orbit resonances):
    #   "length": n_steps ~ U(0.5, 1) * l_max — but the scan always
    #             computes l_max steps, so ~25% of leapfrog work is
    #             discarded on average;
    #   "step":   all l_max steps used, eps scaled by U(0.8, 1.2) per
    #             trajectory — same de-resonance effect, no waste;
    #   "none":   fixed length and step.
    jitter_traj: bool = True     # legacy switch: False forces "none"
    jitter_mode: str = "length"  # length | step | none
    dense_mass: bool = False     # full [P,P] mass matrix (pooled covariance)
    # Pinned parameters (reference: MH step scale 0 pins a dim, e.g. IFMR
    # coefficients in an MS-only run).  1.0 = sampled, 0.0 = frozen.
    # Without this, density-flat dims random-walk through warmup and
    # poison the pooled (co)variance metric (their sample variance is
    # eps^2-scaled noise, and dense cross terms corrupt the live dims —
    # observed as accept == 0 on the multipop posterior).
    free_mask: tuple | None = None
    # Max chains evaluated concurrently inside one device's vmap.  None =
    # all at once.  At large chain counts the batched density's [C, S, T]
    # intermediates (and their VJP residuals) exhaust HBM; chunking runs
    # chain blocks sequentially under lax.map — peak memory is one
    # block's, cross-chain pooling (metric/eps, BETWEEN windows on the
    # collected [C, n, P] samples) is unchanged.
    chain_chunk: int | None = None

    def __post_init__(self):
        # An unrecognized mode would silently behave as "none" (no
        # trajectory randomization) in hmc_transition — fail loudly.
        if self.jitter_mode not in ("length", "step", "none"):
            raise ValueError(
                f"jitter_mode must be 'length', 'step' or 'none' "
                f"(got {self.jitter_mode!r})"
            )

    def mask_array(self, P: int) -> Array:
        if self.free_mask is None:
            return jnp.ones((P,), jnp.float32)
        return jnp.asarray(self.free_mask, jnp.float32)


class DAState(NamedTuple):
    """Nesterov dual-averaging state for log step size."""

    log_eps: Array
    log_eps_avg: Array
    h_avg: Array
    mu: Array
    count: Array


def da_init(eps0: float) -> DAState:
    le = jnp.log(jnp.asarray(eps0, jnp.float32))
    return DAState(
        log_eps=le,
        log_eps_avg=le,
        h_avg=jnp.zeros(()),
        mu=jnp.log(10.0) + le,
        count=jnp.zeros(()),
    )


def da_update(s: DAState, accept_prob: Array, target: float) -> DAState:
    gamma, t0, kappa = 0.05, 10.0, 0.75
    count = s.count + 1.0
    h_avg = (1.0 - 1.0 / (count + t0)) * s.h_avg + (
        target - accept_prob
    ) / (count + t0)
    log_eps = s.mu - jnp.sqrt(count) / gamma * h_avg
    w = count ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * s.log_eps_avg
    return DAState(log_eps, log_eps_avg, h_avg, s.mu, count)


# --- Mass-matrix helpers ------------------------------------------------------
# `inv_mass` is the (estimated) posterior covariance Sigma = M^{-1}: a [P]
# vector (diagonal metric) or a [P,P] matrix (dense metric).  The branch on
# ndim is static at trace time, so both paths compile to straight-line HLO.
# The products ask for full float32 (HIGHEST): a GPU would otherwise be
# free to run them in TF32, and at P <= 12 the precision costs nothing.

_HI = jax.lax.Precision.HIGHEST


def _mass_matvec(inv_mass: Array, p: Array) -> Array:
    """Sigma @ p (the leapfrog drift velocity)."""
    if inv_mass.ndim == 1:
        return inv_mass * p
    return jnp.matmul(inv_mass, p, precision=_HI)


def _kinetic(inv_mass: Array, p: Array) -> Array:
    """K(p) = 0.5 p^T Sigma p (momentum p ~ N(0, Sigma^{-1}))."""
    return 0.5 * jnp.dot(p, _mass_matvec(inv_mass, p), precision=_HI)


def _metric_chol(inv_mass: Array) -> Array:
    """Factor of the metric: sqrt(Sigma) (diag) or cholesky(Sigma) (dense).

    Computed ONCE when the metric is (re)estimated or frozen and passed
    into the transition, so the factorization stays out of the
    per-transition scan body (it is loop-invariant between mass
    re-estimations)."""
    if inv_mass.ndim == 1:
        return jnp.sqrt(inv_mass)
    return jnp.linalg.cholesky(inv_mass)


def _sample_momentum(key: Array, chol: Array, n: int) -> Array:
    """Draw p ~ N(0, M) with M = Sigma^{-1}, given chol = factor(Sigma).

    Dense: Sigma = L L^T  =>  M = L^{-T} L^{-1}, so p = L^{-T} xi has
    Var(p) = M."""
    xi = jax.random.normal(key, (n,))
    if chol.ndim == 1:
        return xi / chol
    return jax.scipy.linalg.solve_triangular(chol.T, xi, lower=False)


class HMCChainState(NamedTuple):
    z: Array         # [P] unconstrained position
    logpost: Array
    grad: Array      # [P] cached gradient at z
    key: Array
    da: DAState


def _leapfrog(logpost_and_grad, z, p, grad, eps, inv_mass, n_steps, l_max,
              mask=None):
    """l_max leapfrog steps; returns the state after `n_steps` (<= l_max).

    All l_max steps are computed (static shape); the trajectory endpoint
    is the scan output at index n_steps-1.  Cost is bounded by l_max
    regardless of jitter, which keeps every chain in a vmap batch on the
    same program.  `mask` zeroes the gradient of pinned dims so frozen
    coordinates never move (their momentum is already zero).
    """
    if mask is not None:
        grad = grad * mask

    def step(carry, _):
        z, p, grad = carry
        p_half = p + 0.5 * eps * grad
        z_new = z + eps * _mass_matvec(inv_mass, p_half)
        lp, g = logpost_and_grad(z_new)
        if mask is not None:
            g = g * mask
        p_new = p_half + 0.5 * eps * g
        return (z_new, p_new, g), (z_new, p_new, lp, g)

    _, (zs, ps, lps, gs) = jax.lax.scan(step, (z, p, grad), None, length=l_max)
    idx = jnp.clip(n_steps - 1, 0, l_max - 1)
    return zs[idx], ps[idx], lps[idx], gs[idx]


def hmc_transition(
    logpost_and_grad: Callable,
    state: HMCChainState,
    eps: Array,
    inv_mass: Array,
    cfg: HMCConfig,
    chol: Array | None = None,
) -> tuple[HMCChainState, Array]:
    """One HMC proposal + MH correction.  Returns (state, accept_prob).

    `chol` is the precomputed factor of inv_mass (see _metric_chol);
    passing it keeps the factorization out of scan bodies."""
    key, k_mom, k_len, k_acc = jax.random.split(state.key, 4)
    P = state.z.shape[0]
    mask = cfg.mask_array(P)
    if chol is None:
        chol = _metric_chol(inv_mass)
    # momentum ~ N(0, M), M = Sigma^{-1} (diagonal or dense); pinned
    # dims carry zero momentum and never move.
    p0 = _sample_momentum(k_mom, chol, P) * mask
    mode = cfg.jitter_mode if cfg.jitter_traj else "none"
    if mode == "length":
        u = jax.random.uniform(k_len, (), minval=0.5, maxval=1.0)
        n_steps = jnp.ceil(u * cfg.l_max).astype(jnp.int32)
    else:
        n_steps = jnp.asarray(cfg.l_max, jnp.int32)
        if mode == "step":
            eps = eps * jax.random.uniform(k_len, (), minval=0.8,
                                           maxval=1.2)

    z1, p1, lp1, g1 = _leapfrog(
        logpost_and_grad, state.z, p0, state.grad, eps, inv_mass,
        n_steps, cfg.l_max, mask=mask,
    )
    ke0 = _kinetic(inv_mass, p0)
    ke1 = _kinetic(inv_mass, p1)
    log_ratio = (lp1 - ke1) - (state.logpost - ke0)
    log_ratio = jnp.where(jnp.isfinite(log_ratio), log_ratio, -jnp.inf)
    accept_prob = jnp.minimum(1.0, jnp.exp(jnp.minimum(log_ratio, 0.0)))
    accept = jnp.log(jax.random.uniform(k_acc, ())) < log_ratio
    accept = accept & (lp1 > NEG_INF / 2)
    new = HMCChainState(
        z=jnp.where(accept, z1, state.z),
        logpost=jnp.where(accept, lp1, state.logpost),
        grad=jnp.where(accept, g1, state.grad),
        key=key,
        da=state.da,
    )
    return new, accept_prob


def _pooled_mean_var(zs: Array, axis_name: str | None):
    """Mean/variance of zs [..., P] pooled over all leading axes and, if
    axis_name is set, over the device axis via psum."""
    P = zs.shape[-1]
    flat = zs.reshape(-1, P)
    n = jnp.asarray(flat.shape[0], jnp.float32)
    s1 = jnp.sum(flat, axis=0)
    s2 = jnp.sum(flat * flat, axis=0)
    if axis_name is not None:
        n = jax.lax.psum(n, axis_name)
        s1 = jax.lax.psum(s1, axis_name)
        s2 = jax.lax.psum(s2, axis_name)
    mean = s1 / n
    var = jnp.maximum(s2 / n - mean * mean, 0.0)
    return mean, var


def _pooled_cov(zs: Array, axis_name: str | None) -> Array:
    """Full covariance of zs [..., P] pooled over all leading axes (and the
    device axis when axis_name is set).

    Centered two-pass form: the mean is pooled first (one [P] psum), then
    the second moment is accumulated on CENTERED samples (one [P,P] psum).
    The one-pass E[xx^T] - mu mu^T form cancels catastrophically in
    float32 for parameters with large mean and small posterior std
    (|mu| ~ 10, sd ~ 1e-3 loses all variance bits and can leave the
    matrix indefinite, silently NaN-ing the Cholesky); centering keeps
    every accumulated quantity O(sd)."""
    P = zs.shape[-1]
    flat = zs.reshape(-1, P)
    n = jnp.asarray(flat.shape[0], jnp.float32)
    s1 = jnp.sum(flat, axis=0)
    if axis_name is not None:
        n = jax.lax.psum(n, axis_name)
        s1 = jax.lax.psum(s1, axis_name)
    mean = s1 / n
    c = flat - mean[None, :]
    s2 = jnp.matmul(c.T, c, precision=_HI)
    if axis_name is not None:
        s2 = jax.lax.psum(s2, axis_name)
    cov = s2 / n
    cov = 0.5 * (cov + cov.T)
    # Stan-style shrinkage toward a scaled identity keeps the metric
    # well-conditioned in early windows; the ridge is scaled to the mean
    # variance (trace/P) so it is meaningful at any parameter scale.
    scale = jnp.trace(cov) / P
    w = n / (n + 5.0)
    reg = (1e-3 * (5.0 / (n + 5.0)) + 1e-7) * jnp.maximum(scale, 1e-12)
    return w * cov + reg * jnp.eye(P)


def _vmap_chains(f, states, chunk: int | None):
    """vmap `f` over the leading chain axis, optionally in sequential
    blocks of `chunk` chains (lax.map) so peak memory is one block's.
    Falls back to a plain vmap when chunking is off or does not divide
    the chain count."""
    C = jax.tree_util.tree_leaves(states)[0].shape[0]
    if chunk is None or chunk >= C or C % chunk != 0:
        return jax.vmap(f)(states)
    G = C // chunk
    blocks = jax.tree_util.tree_map(
        lambda x: x.reshape((G, chunk) + x.shape[1:]), states
    )
    out = jax.lax.map(lambda b: jax.vmap(f)(b), blocks)
    return jax.tree_util.tree_map(
        lambda x: x.reshape((-1,) + x.shape[2:]), out
    )


def init_chains(
    logpost_fn: Callable, init_z: Array, key: Array, cfg: HMCConfig
) -> HMCChainState:
    """Initial per-chain state batch (vmapped leaves, leading axis C)."""
    C, _ = init_z.shape
    vgrad = jax.value_and_grad(logpost_fn)
    keys = jax.random.split(key, C)
    lp0, g0 = jax.vmap(vgrad)(init_z)
    return HMCChainState(
        z=init_z,
        logpost=lp0,
        grad=g0,
        key=keys,
        da=jax.vmap(lambda _: da_init(cfg.init_step))(jnp.arange(C)),
    )


def _window_update(states, inv_mass, zs, w, cfg: HMCConfig, mask,
                   axis_name):
    """Between-window adaptation step, shared by the in-program scan
    (warmup) and the host-chunked path (make_warmup_window).

    Pooled cross-chain (co)variance -> mass matrix (inv_mass = Sigma ~
    posterior covariance).  Pinned dims get a unit diagonal and zero
    cross terms — their warmup samples are frozen, and without the
    projection the dense metric would be singular in those directions.
    The LAST window keeps its incoming metric (terminal eps-only window)
    and its DA average becomes the frozen step size; every earlier
    window installs its estimate and restarts dual averaging at the
    current per-chain eps (Stan's behavior: h_avg/count reset, mu
    re-anchored), so the terminal DA average reflects only the final
    metric."""
    if cfg.dense_mass:
        est = _pooled_cov(zs, axis_name)
        est = (
            est * (mask[:, None] * mask[None, :])
            + jnp.diag(1.0 - mask)
        )
    else:
        _, var = _pooled_mean_var(zs, axis_name)
        est = (var + 1e-6) * mask + (1.0 - mask)
    update = w < cfg.n_windows - 1   # last window: metric frozen
    inv_mass = jnp.where(update, est, inv_mass)
    da = states.da
    fresh = DAState(
        log_eps=da.log_eps,
        log_eps_avg=da.log_eps,
        h_avg=jnp.zeros_like(da.h_avg),
        mu=jnp.log(10.0) + da.log_eps,
        count=jnp.zeros_like(da.count),
    )
    da = jax.tree_util.tree_map(
        lambda f, o: jnp.where(update, f, o), fresh, da
    )
    return states._replace(da=da), inv_mass


def make_warmup_window(
    logpost_fn: Callable,
    cfg: HMCConfig,
    axis_name: str | None = None,
) -> Callable:
    """One warmup window as a standalone jittable function
    `(states, inv_mass, w) -> (states, inv_mass)`.

    Host-looping this over w = 0..n_windows-1 is EXACTLY warmup() (same
    RNG stream, same updates), but each device execution is one window
    long, so the host sees every window boundary (checkpoints,
    streaming diagnostics).  Finish with `freeze_step_size(states,
    axis_name)` for the sampling eps.
    """

    def window_fn(states, inv_mass, w):
        P = states.z.shape[-1]
        mask = cfg.mask_array(P)
        vgrad = jax.value_and_grad(logpost_fn)
        seg_len = max(cfg.n_warmup // cfg.n_windows, 1)
        chol = _metric_chol(inv_mass)

        def one_chain(st):
            def body(st, _):
                eps = jnp.exp(st.da.log_eps)
                st2, ap = hmc_transition(vgrad, st, eps, inv_mass, cfg,
                                         chol=chol)
                st2 = st2._replace(
                    da=da_update(st2.da, ap, cfg.target_accept))
                return st2, st2.z

            return jax.lax.scan(body, st, None, length=seg_len)

        states, zs = _vmap_chains(one_chain, states, cfg.chain_chunk)
        return _window_update(states, inv_mass, zs, w, cfg, mask,
                              axis_name)

    return window_fn


def freeze_step_size(states: HMCChainState,
                     axis_name: str | None = None) -> Array:
    """Frozen sampling eps = cross-chain mean of the terminal window's
    DA average (see warmup)."""
    le = jnp.mean(states.da.log_eps_avg)
    if axis_name is not None:
        le = jax.lax.pmean(le, axis_name)
    return jnp.exp(le)


def warmup(
    logpost_fn: Callable,
    states: HMCChainState,
    cfg: HMCConfig,
    axis_name: str | None = None,
    inv_mass0: Array | None = None,
):
    """Windowed warmup: per-chain dual averaging + pooled cross-chain
    mass estimation between windows.  Returns (states, inv_mass, eps).

    Windows run as a lax.scan over the shared make_warmup_window body
    (not a Python unroll): each extra copy of the density+VJP in the
    program costs real XLA compile time.

    Schedule (Stan-shaped, adapted to equal-length windows):
      window 0 .. n-2   "slow": DA + metric re-estimation AFTER each —
                        the estimate from window w drives window w+1;
      window n-1        "terminal": eps-only DA under the FINAL metric.
    Two invariants the r2 code broke (and that broke sampling — the
    frozen eps was adapted under a metric the sampler never used,
    freezing chains at accept ~ 1):
      1. every metric estimate is USED by a later window (the old
         `w >= 1` gate silently discarded window 0's estimate, so with
         n_windows = 2 the whole warmup ran under the identity metric
         while sampling ran under an unadapted posterior-var metric);
      2. dual averaging RESTARTS when the metric changes (anchored at
         the current eps), so the frozen eps = the terminal window's
         DA average, adapted under exactly the sampling metric.
    """
    P = states.z.shape[-1]
    if inv_mass0 is None:
        # Identity start; pass a posterior-covariance estimate (e.g.
        # from full-rank VI) to warm-start the metric — at pod scale the
        # posterior is too tight for early windows to estimate it from
        # an identity-metric random walk (VERDICT r3 #1).
        inv_mass0 = jnp.eye(P) if cfg.dense_mass else jnp.ones((P,))
    window_fn = make_warmup_window(logpost_fn, cfg, axis_name)

    def window(carry, w):
        states, inv_mass = carry
        states, inv_mass = window_fn(states, inv_mass, w)
        return (states, inv_mass), None

    (states, inv_mass), _ = jax.lax.scan(
        window, (states, inv_mass0), jnp.arange(cfg.n_windows)
    )
    return states, inv_mass, freeze_step_size(states, axis_name)


def sample_chunk(
    logpost_fn: Callable,
    states: HMCChainState,
    inv_mass: Array,
    eps: Array,
    n_record: int,
    cfg: HMCConfig,
):
    """Record `n_record` thinned samples from every chain.
    Returns (states, zs [C, n, P], lps [C, n], accept [C, n])."""
    vgrad = jax.value_and_grad(logpost_fn)
    chol = _metric_chol(inv_mass)  # frozen metric: factor once

    def one_chain(st):
        def body(st, _):
            def inner(s, _):
                s2, ap = hmc_transition(vgrad, s, eps, inv_mass, cfg,
                                        chol=chol)
                return s2, ap

            st, aps = jax.lax.scan(inner, st, None, length=cfg.thin)
            return st, (st.z, st.logpost, jnp.mean(aps))

        return jax.lax.scan(body, st, None, length=n_record)

    states, (zs, lps, aps) = _vmap_chains(one_chain, states, cfg.chain_chunk)
    return states, zs, lps, aps


def run_hmc(
    logpost_fn: Callable,
    init_z: Array,          # [C, P] one row per (local) chain
    key: Array,
    cfg: HMCConfig = HMCConfig(),
    axis_name: str | None = None,
):
    """Warmup (windowed, cross-chain mass adaptation) + sampling.

    Fully traceable — wrap in jit yourself, or in shard_map with
    `axis_name` set to the chain mesh axis.  Returns (samples
    [n_rec, C, P] in unconstrained space, info dict).
    """
    states = init_chains(logpost_fn, init_z, key, cfg)
    states, inv_mass, eps_final = warmup(logpost_fn, states, cfg, axis_name)
    states, zs, lps, aps = sample_chunk(
        logpost_fn, states, inv_mass, eps_final,
        cfg.n_samples // cfg.thin, cfg,
    )
    samples = jnp.swapaxes(zs, 0, 1)  # [n_rec, C, P]
    info = dict(
        accept_prob=jnp.mean(aps),
        step_size=eps_final,
        inv_mass=inv_mass,
        logposts=jnp.swapaxes(lps, 0, 1),
        final_states=states,
    )
    return samples, info
