"""Sharded posterior evaluation and sampler drivers (shard_map).

This is the scale-out layer of the framework (SURVEY.md §7 step 5): the
single-chip log-posterior of base_tpu.model.posterior becomes, unchanged,
a 2-D-sharded program:

  - stars are split across the "stars" mesh axis; every device computes
    its shard's per-star marginal likelihoods and the total rides one
    `psum` (the partial sums are scalars — ICI traffic per proposal is a
    few bytes, the blockwise/ring-attention property of SURVEY.md §2.4);
  - chains are split across the "chains" axis; each device vmaps its
    local block, and warmup adaptation pools across devices with
    psum/pmean inside the sampler itself (hmc.run_hmc axis_name).

The density is the FULL single-pop density — WD branch and fused Pallas
kernel included (it delegates to posterior.log_lik on the local star
shards), so pod-scale runs carry every physics path the one-chip CLI
does.  Gradients flow through psum (its transpose is psum), so the same
machinery serves HMC/NUTS.  Everything here also runs on a 1-device
mesh, which is how CI exercises the exact collective code paths on 8
fake CPU devices (SURVEY.md §4.2 item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax import shard_map
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from base_tpu.model import posterior as post_mod
from base_tpu.model.posterior import SinglePopModel
from base_tpu.model.stardata import MSStars
from base_tpu.ops.special import NEG_INF
from base_tpu.parallel.mesh import CHAIN_AXIS, STAR_AXIS, pad_to_multiple

from base_tpu.inference import driver as driver_mod
from base_tpu.inference import hmc as hmc_mod
from base_tpu.inference import mh as mh_mod


def _model_log_lik(model, params):
    """Dispatch to the model family's (ll, in_bounds) likelihood.

    Both SinglePopModel and MultiPopModel expose the same contract —
    per-LOCAL-star log-lik sum plus a replicated bounds flag — which is
    what makes every sharded runner below model-agnostic (VERDICT r3
    #3: multiPop is first-class in the scale-out layer)."""
    if isinstance(model, SinglePopModel):
        return post_mod.log_lik(model, params)
    from base_tpu.model import multipop as mp

    if isinstance(model, mp.MultiPopModel):
        return mp.log_lik(model, params)
    raise TypeError(f"no sharded log_lik for {type(model).__name__}")


def shard_stars(model, mesh: Mesh):
    """Pad the star axes to the star-shard count and place each per-star
    array with a NamedSharding over the "stars" axis — MS stars AND WD
    stars both shard; grids and other model leaves stay replicated.
    Works for any model dataclass with `stars`/`wd_stars` fields
    (single-pop and multiPop)."""
    n_star_shards = mesh.shape[STAR_AXIS]

    def place(x):
        s = NamedSharding(mesh, P(STAR_AXIS))
        return jax.device_put(x, s)

    def prep(stars):
        if stars is None:
            return None
        S = stars.n_stars
        S_pad = pad_to_multiple(S, n_star_shards)
        if S_pad != S:
            stars = _repad_stars(stars, S_pad)
        return jax.tree_util.tree_map(place, stars)

    return dataclasses.replace(
        model, stars=prep(model.stars), wd_stars=prep(model.wd_stars)
    )


def _repad_stars(stars: MSStars, pad_to: int) -> MSStars:
    """Host-side re-pad of an MSStars pytree to a larger static S."""
    extra = pad_to - stars.n_stars

    def pad(x, val=0.0):
        x = np.asarray(x)
        w = [(0, extra)] + [(0, 0)] * (x.ndim - 1)
        return jnp.asarray(np.pad(x, w, constant_values=val))

    return MSStars(
        obs_over_var=pad(stars.obs_over_var),
        inv_var=pad(stars.inv_var),
        c0=pad(stars.c0),
        log_norm=pad(stars.log_norm),
        log_cm=pad(stars.log_cm, -1.0),
        log_1m_cm=pad(stars.log_1m_cm, -1.0),
        field_logdens=pad(stars.field_logdens),
        star_mask=pad(stars.star_mask),
        obs_mags=pad(stars.obs_mags),
        obs_sigma=pad(stars.obs_sigma, -9.0),
    )


def local_logpost_fn(
    model,
    stars_local: MSStars,
    star_axis: str | None,
    wd_local: MSStars | None = None,
) -> Callable[[Array], Array]:
    """Per-device log posterior: local star partial (the FULL density —
    MS marginal incl. optional Pallas kernel, plus the WD precursor
    branch when wd_local is present; single-pop or multiPop via
    _model_log_lik) + psum over the star axis + (replicated) prior.
    Identical on every device after the psum.
    """
    local = dataclasses.replace(model, stars=stars_local, wd_stars=wd_local)

    def f(params: Array) -> Array:
        ll, in_bounds = _model_log_lik(local, params)
        if star_axis is not None:
            ll = jax.lax.psum(ll, star_axis)
        lp = local.priors.log_prior(params)
        return jnp.where(in_bounds, ll + lp, NEG_INF)

    return f


def _star_specs(stars):
    return jax.tree_util.tree_map(lambda _: P(STAR_AXIS), stars)


def _pvary(x, axis: str):
    """Mark x device-varying along `axis` iff it is not already.

    With check_vma=True (mandatory here: it is what makes grad-of-psum
    insert the correct transpose collectives — without it the star-axis
    psum backprop silently drops every other shard's gradient
    contribution), scan carries must enter with their steady-state vma.
    Sampler adaptation state (dual-averaging, proposal covariances)
    starts replicated but becomes chain-varying after one update, so the
    initial carry is pcast up front."""
    vma = getattr(jax.typeof(x), "vma", frozenset())
    if axis in vma:
        return x
    return jax.lax.pcast(x, (axis,), to="varying")


def _pvary_tree(tree, axis: str = CHAIN_AXIS):
    return jax.tree_util.tree_map(lambda x: _pvary(x, axis), tree)


def _split_frame(model, mesh: Mesh):
    """shard model -> (frame without stars, sharded MS stars, sharded WD
    stars or None).  The frame closes over the shard_map'd functions;
    the star pytrees pass through shard_map args with star-axis specs."""
    model = shard_stars(model, mesh)
    frame = dataclasses.replace(model, stars=None, wd_stars=None)
    return frame, model.stars, model.wd_stars


def make_sharded_hmc_fns(
    model,  # SinglePopModel | MultiPopModel
    transform,
    cfg: hmc_mod.HMCConfig,
    mesh: Mesh,
    chunk: int,
    inv_mass0=None,
):
    """(warm, step) pair with the driver contract, shard_map'd over the
    (chains x stars) mesh — the building blocks of both run_hmc_sharded
    and the checkpointed sharded driver.  `inv_mass0` warm-starts the
    warmup metric (e.g. a full-rank-VI covariance — the pod-scale
    initialization path)."""
    frame, stars, wds = _split_frame(model, mesh)

    def make_logpost_z(stars_local, wd_local):
        base = local_logpost_fn(frame, stars_local, STAR_AXIS, wd_local)

        def logpost_z(z):
            x = transform.forward(z)
            return base(x) + transform.log_det_jacobian(z)

        return logpost_z

    def warm_dev(stars_local, wd_local, init_z_local, key):
        ci = jax.lax.axis_index(CHAIN_AXIS)
        # All star-shards of one chain block MUST share the same RNG
        # stream: their psum-ed logpost is identical, and identical keys
        # keep proposals/accepts in lockstep (no cross-shard divergence).
        dkey = jax.random.fold_in(key, ci)
        fz = make_logpost_z(stars_local, wd_local)
        states = hmc_mod.init_chains(fz, init_z_local, dkey, cfg)
        states = _pvary_tree(states)
        return hmc_mod.warmup(fz, states, cfg, axis_name=CHAIN_AXIS,
                              inv_mass0=inv_mass0)

    def step_dev(stars_local, wd_local, states, inv_mass, eps):
        fz = make_logpost_z(stars_local, wd_local)
        return hmc_mod.sample_chunk(fz, states, inv_mass, eps, chunk, cfg)

    state_spec = P(CHAIN_AXIS)
    warm_fn = shard_map(
        warm_dev,
        mesh=mesh,
        in_specs=(_star_specs(stars), _star_specs(wds),
                  P(CHAIN_AXIS, None), P()),
        out_specs=(
            jax.tree_util.tree_map(lambda _: state_spec,
                                   _state_structure()),
            P(), P(),
        ),
        check_vma=True,
    )
    step_fn = shard_map(
        step_dev,
        mesh=mesh,
        in_specs=(_star_specs(stars), _star_specs(wds),
                  jax.tree_util.tree_map(lambda _: state_spec,
                                         _state_structure()),
                  P(), P()),
        out_specs=(
            jax.tree_util.tree_map(lambda _: state_spec,
                                   _state_structure()),
            P(CHAIN_AXIS), P(CHAIN_AXIS), P(CHAIN_AXIS),
        ),
        check_vma=True,
    )

    warm = jax.jit(lambda z, k: warm_fn(stars, wds, z, k))
    step = jax.jit(lambda st, im, eps: step_fn(stars, wds, st, im, eps))
    return warm, step


def _state_structure():
    """An HMCChainState-shaped pytree of placeholders, used only to build
    matching PartitionSpec trees (every leaf has leading chain axis)."""
    zero = 0
    return hmc_mod.HMCChainState(
        z=zero, logpost=zero, grad=zero, key=zero,
        da=hmc_mod.DAState(zero, zero, zero, zero, zero),
    )


def run_hmc_sharded(
    model,  # SinglePopModel | MultiPopModel
    transform,
    init_z: Array,   # [C_total, P] unconstrained initial positions
    key: Array,
    cfg: hmc_mod.HMCConfig,
    mesh: Mesh,
    inv_mass0=None,
):
    """HMC over a (chains x stars) mesh.  Returns (z samples
    [n_rec, C_total, P], info) with device-invariant info scalars."""
    n_rec = cfg.n_samples // cfg.thin
    warm, step = make_sharded_hmc_fns(model, transform, cfg, mesh, n_rec,
                                      inv_mass0=inv_mass0)
    states, inv_mass, eps = warm(init_z, key)
    states, zs, lps, aps = step(states, inv_mass, eps)
    samples = jnp.swapaxes(zs, 0, 1)   # [n_rec, C_total, P]
    return samples, dict(
        accept_prob=jnp.mean(aps), step_size=eps, inv_mass=inv_mass,
        logposts=jnp.swapaxes(lps, 0, 1),
    )


def run_hmc_sharded_checkpointed(
    model,  # SinglePopModel | MultiPopModel
    transform,
    init_z: Array,   # [C_total, P]
    key: Array,
    cfg: hmc_mod.HMCConfig,
    mesh: Mesh,
    dcfg: driver_mod.DriverConfig = driver_mod.DriverConfig(),
):
    """Sharded HMC with chunked checkpoint/resume: the shard_map'd
    (warm, step) pair drives the same resume loop as the single-device
    path, so a killed pod run resumes bit-identically (SURVEY.md §5)."""
    n_rec = cfg.n_samples // cfg.thin
    chunk = max(min(dcfg.chunk_size, n_rec), 1)
    warm, step = make_sharded_hmc_fns(model, transform, cfg, mesh, chunk)
    return driver_mod.run_checkpointed(warm, step, init_z, key, cfg, dcfg)


def run_nuts_sharded(
    model,  # SinglePopModel | MultiPopModel
    transform,
    init_z: Array,   # [C_total, P]
    key: Array,
    cfg,             # nuts.NUTSConfig
    mesh: Mesh,
):
    """NUTS over the (chains x stars) mesh — same contract as
    run_hmc_sharded (dual averaging pools across devices inside
    nuts.run_nuts via axis_name)."""
    from base_tpu.inference import nuts as nuts_mod

    frame, stars, wds = _split_frame(model, mesh)

    def device_fn(stars_local, wd_local, init_z_local, key):
        ci = jax.lax.axis_index(CHAIN_AXIS)
        dkey = jax.random.fold_in(key, ci)
        base = local_logpost_fn(frame, stars_local, STAR_AXIS, wd_local)

        def logpost_z(z):
            x = transform.forward(z)
            return base(x) + transform.log_det_jacobian(z)

        samples, info = nuts_mod.run_nuts(
            logpost_z, init_z_local, dkey, cfg, axis_name=CHAIN_AXIS
        )
        accept = jax.lax.pmean(info["accept_prob"], CHAIN_AXIS)
        nlf = jax.lax.pmean(info["mean_leapfrogs"], CHAIN_AXIS)
        return samples, accept, info["step_size"], info["inv_mass"], nlf

    fn = shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(_star_specs(stars), _star_specs(wds),
                  P(CHAIN_AXIS, None), P()),
        out_specs=(P(None, CHAIN_AXIS, None), P(), P(), P(), P()),
        check_vma=True,
    )
    samples, accept, step_size, inv_mass, nlf = jax.jit(fn)(
        stars, wds, init_z, key
    )
    return samples, dict(
        accept_prob=accept, step_size=step_size, inv_mass=inv_mass,
        mean_leapfrogs=nlf,
    )


def run_smc_sharded(
    model,  # SinglePopModel | MultiPopModel
    transform,
    center_z: Array,        # [P] q0 center in unconstrained space
    key: Array,
    cfg,                    # smc.SMCConfig (n_particles = PER SHARD)
    mesh: Mesh,
    q0_sd: float = 0.5,
):
    """Tempered SMC over the (chains x stars) mesh: particles shard on
    the chain axis (pooled-weight systematic resampling via all_gather),
    stars shard inside the density via psum — the pod-scale
    BASELINE.json:11 configuration.  Returns (particles [N_total, P],
    info)."""
    from base_tpu.inference import smc as smc_mod

    frame, stars, wds = _split_frame(model, mesh)
    P_dim = center_z.shape[0]

    def device_fn(stars_local, wd_local, key):
        ci = jax.lax.axis_index(CHAIN_AXIS)
        base = local_logpost_fn(frame, stars_local, STAR_AXIS, wd_local)

        def log_target(z):
            x = transform.forward(z)
            return base(x) + transform.log_det_jacobian(z)

        def log_q0(z):
            return jnp.sum(
                -0.5 * ((z - center_z) / q0_sd) ** 2
                - jnp.log(q0_sd) - 0.9189385332046727
            )

        def sample_q0(k, n):
            # distinct particles per chain shard, identical across star
            # shards (their psum-ed density keeps them in lockstep)
            kk = jax.random.fold_in(k, ci)
            return center_z[None, :] + q0_sd * jax.random.normal(
                kk, (n, P_dim)
            )

        return smc_mod.run_smc(
            log_target, sample_q0, log_q0, key, cfg,
            axis_name=CHAIN_AXIS,
        )

    fn = shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(_star_specs(stars), _star_specs(wds), P()),
        out_specs=(
            P(CHAIN_AXIS, None),
            dict(log_evidence=P(), beta=P(), n_stages=P(), accept=P(),
                 betas=P(), move_scale=P()),
        ),
        check_vma=True,
    )
    particles, info = jax.jit(fn)(stars, wds, key)
    return particles, info


def run_vi_sharded(
    model,  # SinglePopModel | MultiPopModel
    transform,
    z0: Array,        # [P] unconstrained start (VI mean init)
    key: Array,
    cfg,              # vi.VIConfig
    mesh: Mesh,
    chunk_steps: int = 100,
):
    """ADVI over the (chains x stars) mesh — the sharded warm-start path
    (VERDICT r4 #6: pod-scale VI init previously required the whole star
    set on one chip).

    Parallel structure: stars shard inside the density (psum over the
    star axis, exactly as every sampler above); the chain axis carries
    DATA-parallel ELBO Monte Carlo — each chain shard draws its OWN
    cfg.n_mc reparameterized samples (fold_in on the chain index) and
    the ELBO gradient is pmean-pooled across the axis, so a c-way chain
    axis multiplies the MC sample count by c at fixed wall clock.  The
    variational parameters stay replicated: they start replicated and
    every Adam update applies the identical pooled gradient.

    Host-chunked like vi.run_vi_chunked (one scan execution per
    chunk_steps).  Returns a vi.VIResult.
    """
    from base_tpu.inference import vi as vi_mod

    frame, stars, wds = _split_frame(model, mesh)
    opt = vi_mod.optax.adam(cfg.learning_rate)
    params0 = vi_mod._init_params(z0, cfg)
    opt_state0 = opt.init(params0)

    def device_fn(stars_local, wd_local, params, opt_state, keys):
        ci = jax.lax.axis_index(CHAIN_AXIS)
        base = local_logpost_fn(frame, stars_local, STAR_AXIS, wd_local)

        def logpost_z(z):
            x = transform.forward(z)
            return base(x) + transform.log_det_jacobian(z)

        def neg_elbo(params, k):
            z, entropy = vi_mod._sample_and_entropy(
                params, jax.random.fold_in(k, ci), cfg.n_mc, cfg.full_rank
            )
            lp = jax.vmap(logpost_z)(z)
            return -(jnp.mean(lp) + entropy)

        def step(carry, k):
            params, opt_state = carry
            loss, g = jax.value_and_grad(neg_elbo)(params, k)
            # Pool the MC gradient across chain shards; params stay
            # replicated because every shard applies this same update.
            g = jax.tree_util.tree_map(
                lambda x: jax.lax.pmean(x, CHAIN_AXIS), g
            )
            loss = jax.lax.pmean(loss, CHAIN_AXIS)
            updates, opt_state = opt.update(g, opt_state)
            params = vi_mod.optax.apply_updates(params, updates)
            return (params, opt_state), -loss

        return jax.lax.scan(step, (params, opt_state), keys)

    rep = lambda tree: jax.tree_util.tree_map(lambda _: P(), tree)
    fn = jax.jit(shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(_star_specs(stars), _star_specs(wds),
                  rep(params0), rep(opt_state0), P()),
        out_specs=((rep(params0), rep(opt_state0)), P()),
        check_vma=True,
    ))

    keys = jax.random.split(key, cfg.n_steps)
    carry = (params0, opt_state0)
    elbos = []
    for lo in range(0, cfg.n_steps, chunk_steps):
        carry, e = fn(stars, wds, carry[0], carry[1],
                      keys[lo : lo + chunk_steps])
        elbos.append(e)
    params, _ = carry
    elbo_trace = jnp.concatenate(elbos)

    if cfg.full_rank:
        diag = jax.nn.softplus(jnp.diagonal(params["tril"])) + 1e-6
        scale = jnp.tril(params["tril"], -1) + jnp.diag(diag)
    else:
        scale = jnp.exp(params["log_sd"])
    return vi_mod.VIResult(
        mu=params["mu"], scale=scale, elbo_trace=elbo_trace,
        final_elbo=jnp.mean(elbo_trace[-50:]),
    )


def vi_warm_start_sharded(
    model,
    transform,
    z0: Array,
    key: Array,
    n_chains: int,
    mesh: Mesh,
    free_mask=None,
    cfg=None,
    chunk_steps: int = 100,
):
    """Sharded analog of vi.vi_warm_start: full-rank VI over the mesh ->
    (init_z [C, P], inv_mass0 [P, P], VIResult) for the pod recipe
    (sharded VI init feeding run_hmc_sharded's inv_mass0)."""
    from base_tpu.inference import vi as vi_mod

    if cfg is None:
        cfg = vi_mod.VIConfig(n_steps=600, n_mc=8, full_rank=True,
                              learning_rate=2e-2, init_log_sd=-4.0)
    res = run_vi_sharded(model, transform, z0, key, cfg, mesh, chunk_steps)
    cov = vi_mod.posterior_covariance(res)
    draws = vi_mod.sample_posterior(res, jax.random.fold_in(key, 1),
                                    n_chains)
    if free_mask is not None:
        m = jnp.asarray(free_mask, jnp.float32)
        cov = cov * (m[:, None] * m[None, :]) + jnp.diag(1.0 - m)
        draws = jnp.where(m[None, :] > 0, draws, z0[None, :])
    return draws, cov, res


def run_mh_sharded(
    model,  # SinglePopModel | MultiPopModel
    init_position: Array,   # [C_total, P]
    key: Array,
    step_init: Array,       # [P]
    cfg: mh_mod.MHConfig,
    mesh: Mesh,
    burn_model=None,
):
    """Reference-parity adaptive MH over the (chains x stars) mesh.
    Chains are embarrassingly parallel; stars psum inside the density.

    `burn_model` (optional): a model over the useDuringBurnIn star
    subset [SURVEY.md C3/C14]; its stars shard over the same star axis
    and stages 1-2 target its psum-ed density, so reference-parity
    burn-in keeps full mesh scaling (VERDICT r4 weak #8)."""
    frame, stars, wds = _split_frame(model, mesh)
    if burn_model is not None:
        bframe, bstars, bwds = _split_frame(burn_model, mesh)
    else:
        bframe, bstars, bwds = None, None, None

    def device_fn(stars_local, wd_local, bstars_local, bwd_local,
                  init_local, key):
        ci = jax.lax.axis_index(CHAIN_AXIS)
        dkey = jax.random.fold_in(key, ci)
        f = local_logpost_fn(frame, stars_local, STAR_AXIS, wd_local)
        f_burn = None
        if bframe is not None:
            f_burn = local_logpost_fn(
                bframe, bstars_local, STAR_AXIS, bwd_local
            )

        def one_chain(pos, k):
            return mh_mod.run_adaptive_mh(
                f, pos, k, step_init, cfg, logpost_burnin_fn=f_burn
            )

        C_local = init_local.shape[0]
        keys = jax.random.split(dkey, C_local)
        samples, info = jax.vmap(one_chain)(init_local, keys)
        acc = jax.lax.pmean(jnp.mean(info["accept_rate"]), CHAIN_AXIS)
        return samples, info["logposts"], acc

    fn = shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(_star_specs(stars), _star_specs(wds),
                  _star_specs(bstars), _star_specs(bwds),
                  P(CHAIN_AXIS, None), P()),
        out_specs=(P(CHAIN_AXIS, None, None), P(CHAIN_AXIS, None), P()),
        check_vma=True,
    )
    samples, logposts, accept = jax.jit(fn)(
        stars, wds, bstars, bwds, init_position, key
    )
    # [C_total, n_rec, P] -> [n_rec, C_total, P] to match diagnostics.
    return jnp.swapaxes(samples, 0, 1), dict(
        accept_rate=accept, logposts=logposts
    )
