"""Fused per-star marginal likelihood: a Pallas kernel for the GPU.

Computes model.likelihood.ms_star_log_marginals in one pass through the
Triton route of Pallas.  The plain jnp path materialises the alpha,
beta, gamma and terms [S, T] intermediates (per chain) in device memory
and reads them back for the reduction and again for autodiff; here each
program keeps its [S_t, T_t] tile in registers and only the [B, T]
table and the [B, S] photometry are read.

Math is the jnp path's linear-space formulation: per (star s, segment
t), with chi2(u) = alpha u^2 - 2 beta u + gamma,

  term = exp(core - m) * width
  core = -(resid + u_near^2)/2 + logw      (flat segments: -chi2(1/2)/2)
  width = sqrt(2 pi / alpha) * (Phi(u1) - Phi(u0)) e^{u_near^2/2}
  out[s] = m + log(sum_t term + 1e-15) + log_norm[s]

with the Phi difference from the shared ops.special.phi_interval_scaled
(an erf polynomial: Triton lowers no erf primitive).

Forward: one program per (star tile, run of segment tiles).  It walks
its segment tiles in a loop, keeping a running (max, sum) per star in
registers; the few runs per star tile are merged by a log-sum-exp in
jnp.  Nothing is carried between programs, which run in any order.

Backward: one program per segment tile.  It loops over the star tiles
and accumulates its own d lo, d hi and d logw, so no reduction crosses
programs.  The d/d{alpha, beta, gamma} sensitivities are the analytic
truncated-Gaussian moments: for I = int_0^1 exp(-chi2(t)/2) dt,

  d log I / d gamma = -1/2,  d log I / d beta = <t>,
  d log I / d alpha = -<t^2>/2,

with <t>, <t^2> from the same scaled phi/Phi pieces the forward
computes.  The softmax weights are recomputed from the saved output.
Photometry inputs get zero cotangents (they are data).

Bands are looped over with one ref row per band (a slice of a loaded
value does not lower on this route); the band count needs no padding.
Stars are padded with zero inverse variance (and zero cotangent),
segments with mask 0.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import Array, lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from base_tpu.ops.special import phi_interval_scaled

NEG_BIG = -1e30
SQRT_2PI = 2.5066282746310002
INV_SQRT_2PI = 0.3989422804014327
_ALPHA_EPS = 1e-12
_FLAT_EPS = 3e-7


@dataclasses.dataclass(frozen=True)
class Tiles:
    """Block shapes and launch parameters (all tile sizes powers of 2)."""

    s: int = 8                   # stars per tile
    t: int = 128                 # segments per tile
    t_tiles_per_program: int = 8  # forward: segment tiles one program walks
    num_warps: int = 4


# Fastest of a 7-point sweep on an H100 (700 W) at the shipped defaults
# (S 100, T 5056, B 8, 64 tables): 1.39 ms forward + gradient against
# 1.55 ms for (16, 64) and 6.7 ms for (32, 128, 8 warps); PERF.md.
TILES = Tiles()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _abg(obs, iv, lo, hi):
    """alpha, beta, gamma [S_t, T_t] from per-band rows: obs/iv are lists
    of [S_t] vectors, lo/hi lists of [T_t] vectors.  Residual form
    (r = obs - lo is O(sigma) near the peak), as in the jnp path."""
    alpha = beta = gamma = None
    for o_b, iv_b, lo_b, hi_b in zip(obs, iv, lo, hi):
        w = iv_b[:, None]
        d = (hi_b - lo_b)[None, :]
        r = o_b[:, None] - lo_b[None, :]
        a, b, c = w * d * d, w * r * d, w * r * r
        if alpha is None:
            alpha, beta, gamma = a, b, c
        else:
            alpha, beta, gamma = alpha + a, beta + b, gamma + c
    return alpha, beta, gamma


def _core_width_of(alpha, beta, gamma, logw, maskf):
    """(core, width, aux) as a pure function of (alpha, beta, gamma):
    core = on-segment chi2 minimum term + logw (NEG_BIG where masked),
    width = the O(1) scaled Gaussian segment integral.  Shared by both
    kernels; identical math to likelihood.ms_star_log_marginals."""
    ac = jnp.maximum(alpha, _ALPHA_EPS)
    rsq = lax.rsqrt(ac)
    mu = beta * rsq * rsq
    resid = jnp.maximum(gamma - beta * mu, 0.0)
    sq = ac * rsq
    u0 = -mu * sq
    u1 = sq - mu * sq
    width_s, unear_sq = phi_interval_scaled(u0, u1)
    live = alpha > _FLAT_EPS
    mid = gamma - beta + 0.25 * alpha
    core = jnp.where(live, -0.5 * (resid + unear_sq), -0.5 * mid) + logw
    core = jnp.where(maskf > 0.5, core, NEG_BIG)
    width = jnp.where(live, SQRT_2PI * rsq * width_s, 1.0)
    return core, width, (u0, u1, width_s, unear_sq, live, mu, rsq)


def _moments(aux):
    """(<t>, <t^2>) of the [0, 1]-truncated Gaussian of each segment.
    phi_s = phi(u) e^{u_near^2/2} shares the forward's scaling, so every
    ratio is O(1) even in far tails.  Flat segments used the midpoint
    value, whose exact sensitivities are the t -> 1/2 point moments."""
    u0, u1, width_s, unear_sq, live, mu, sigma = aux
    phi_s0 = INV_SQRT_2PI * jnp.exp(0.5 * jnp.minimum(unear_sq - u0 * u0, 0.0))
    phi_s1 = INV_SQRT_2PI * jnp.exp(0.5 * jnp.minimum(unear_sq - u1 * u1, 0.0))
    zs = jnp.maximum(width_s, 1e-12)
    r1 = (phi_s0 - phi_s1) / zs
    t1 = jnp.clip(mu + sigma * r1, 0.0, 1.0)
    t2 = (
        sigma * sigma * (1.0 + (u0 * phi_s0 - u1 * phi_s1) / zs)
        + mu * mu + 2.0 * mu * sigma * r1
    )
    t2 = jnp.clip(t2, 0.0, 1.0)
    return jnp.where(live, t1, 0.5), jnp.where(live, t2, 0.25)


def _fwd_kernel(obsT_ref, ivT_ref, loT_ref, hiT_ref, logw_ref, mask_ref,
                m_ref, s_ref, *, n_bands: int, n_inner: int, tiles: Tiles):
    si = pl.program_id(0)
    ci = pl.program_id(1)
    ssl = pl.ds(si * tiles.s, tiles.s)
    obs = [obsT_ref[b, ssl] for b in range(n_bands)]
    iv = [ivT_ref[b, ssl] for b in range(n_bands)]
    t_base = ci * (n_inner * tiles.t)

    def body(i, carry):
        m, s = carry
        tsl = pl.ds(t_base + i * tiles.t, tiles.t)
        lo = [loT_ref[b, tsl] for b in range(n_bands)]
        hi = [hiT_ref[b, tsl] for b in range(n_bands)]
        maskf = mask_ref[tsl][None, :]
        core, width, _ = _core_width_of(
            *_abg(obs, iv, lo, hi), logw_ref[tsl][None, :], maskf
        )
        m_new = jnp.maximum(m, jnp.max(core, axis=1))
        terms = jnp.where(
            maskf > 0.5, jnp.exp(core - m_new[:, None]) * width, 0.0
        )
        return m_new, s * jnp.exp(m - m_new) + jnp.sum(terms, axis=1)

    init = (jnp.full((tiles.s,), NEG_BIG, jnp.float32),
            jnp.zeros((tiles.s,), jnp.float32))
    m, s = lax.fori_loop(0, n_inner, body, init)
    m_ref[ci, ssl] = m
    s_ref[ci, ssl] = s


def _bwd_kernel(obsT_ref, ivT_ref, loT_ref, hiT_ref, logw_ref, mask_ref,
                out_ref, g_ref, dlo_ref, dhi_ref, dlogw_ref,
                *, n_bands: int, n_s_tiles: int, tiles: Tiles):
    tsl = pl.ds(pl.program_id(0) * tiles.t, tiles.t)
    lo = [loT_ref[b, tsl] for b in range(n_bands)]
    hi = [hiT_ref[b, tsl] for b in range(n_bands)]
    logw = logw_ref[tsl][None, :]
    maskf = mask_ref[tsl][None, :]

    def body(j, acc):
        ssl = pl.ds(j * tiles.s, tiles.s)
        obs = [obsT_ref[b, ssl] for b in range(n_bands)]
        iv = [ivT_ref[b, ssl] for b in range(n_bands)]
        core, width, aux = _core_width_of(*_abg(obs, iv, lo, hi), logw, maskf)
        # exp(core - out) * width = term / sum: the softmax weight.
        gw = g_ref[ssl][:, None] * jnp.exp(core - out_ref[ssl][:, None]) * width
        t1, t2 = _moments(aux)
        # d alpha/d lo = -2 iv d, d beta/d lo = -iv (d + r),
        # d gamma/d lo = -2 iv r; d alpha/d hi = 2 iv d, d beta/d hi = iv r;
        # with ga = -gw <t^2>/2, gb = gw <t>, gc = -gw/2 these collapse to
        # d lo = iv (d gw (<t^2> - <t>) + r gw (1 - <t>)),
        # d hi = iv (r gw <t> - d gw <t^2>).
        g1 = gw * t1
        g2 = gw * t2
        new = []
        for b in range(n_bands):
            w = iv[b][:, None]
            d = (hi[b] - lo[b])[None, :]
            r = obs[b][:, None] - lo[b][None, :]
            new.append(acc[b] + jnp.sum(w * (d * (g2 - g1) + r * (gw - g1)),
                                        axis=0))
        for b in range(n_bands):
            w = iv[b][:, None]
            d = (hi[b] - lo[b])[None, :]
            r = obs[b][:, None] - lo[b][None, :]
            new.append(acc[n_bands + b]
                       + jnp.sum(w * (r * g1 - d * g2), axis=0))
        new.append(acc[-1] + jnp.sum(gw, axis=0))
        return tuple(new)

    zero = jnp.zeros((tiles.t,), jnp.float32)
    acc = lax.fori_loop(0, n_s_tiles, body, (zero,) * (2 * n_bands + 1))
    for b in range(n_bands):
        dlo_ref[b, tsl] = acc[b]
        dhi_ref[b, tsl] = acc[n_bands + b]
    dlogw_ref[tsl] = acc[-1]


def _pad_to(x, n, axis, value=0.0):
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=value)


def _layout(S: int, T: int, tiles: Tiles):
    """(Sp, Tp, n_split, n_inner): padded sizes, forward runs per star
    tile and segment tiles per run."""
    n_t = _cdiv(T, tiles.t)
    n_split = _cdiv(n_t, tiles.t_tiles_per_program)
    n_inner = _cdiv(n_t, n_split)
    return (_cdiv(S, tiles.s) * tiles.s, n_split * n_inner * tiles.t,
            n_split, n_inner)


def _out(shape, *inputs):
    """Output spec varying over every mesh axis an input varies over
    (shard_map with check_vma needs it; empty outside shard_map)."""
    vma = frozenset().union(*(jax.typeof(x).vma for x in inputs))
    return jax.ShapeDtypeStruct(shape, jnp.float32, vma=vma)


def _params(tiles: Tiles):
    return plgpu.CompilerParams(num_warps=tiles.num_warps, num_stages=2)


def _padded_inputs(obs, inv_var, lo, hi, logw, maskf, Sp, Tp):
    return (
        _pad_to(obs.T, Sp, 1), _pad_to(inv_var.T, Sp, 1),   # [B, Sp]
        _pad_to(lo.T, Tp, 1), _pad_to(hi.T, Tp, 1),         # [B, Tp]
        _pad_to(logw, Tp, 0), _pad_to(maskf, Tp, 0),        # [Tp]
    )


def _fwd(obs, inv_var, log_norm, lo, hi, logw, maskf, interpret, tiles):
    S, B = obs.shape
    T = lo.shape[0]
    Sp, Tp, n_split, n_inner = _layout(S, T, tiles)
    args = _padded_inputs(obs, inv_var, lo, hi, logw, maskf, Sp, Tp)
    part = _out((n_split, Sp), *args)
    m, s = pl.pallas_call(
        functools.partial(_fwd_kernel, n_bands=B, n_inner=n_inner,
                          tiles=tiles),
        grid=(Sp // tiles.s, n_split),
        out_shape=(part, part),
        backend="triton",
        compiler_params=_params(tiles),
        interpret=interpret,
        name="marglik_fwd",
    )(*args)
    mx = jnp.max(m, axis=0)
    tot = jnp.sum(s * jnp.exp(m - mx[None, :]), axis=0)
    core = jnp.where(tot > 0, mx + jnp.log(tot + 1e-15), NEG_BIG)[:S]
    return core + log_norm, (obs, inv_var, lo, hi, logw, maskf, core)


def _bwd(interpret, tiles, residuals, g):
    obs, inv_var, lo, hi, logw, maskf, core = residuals
    S, B = obs.shape
    T = lo.shape[0]
    Sp, Tp, _, _ = _layout(S, T, tiles)
    # Padded stars: g = 0 and an output of +1e30 give them zero weight.
    out_p = _pad_to(core, Sp, 0, value=-NEG_BIG)
    g_p = _pad_to(g, Sp, 0)
    args = (*_padded_inputs(obs, inv_var, lo, hi, logw, maskf, Sp, Tp),
            out_p, g_p)
    dloT, dhiT, dlogw = pl.pallas_call(
        functools.partial(_bwd_kernel, n_bands=B, n_s_tiles=Sp // tiles.s,
                          tiles=tiles),
        grid=(Tp // tiles.t,),
        out_shape=(_out((B, Tp), *args), _out((B, Tp), *args),
                   _out((Tp,), *args)),
        backend="triton",
        compiler_params=_params(tiles),
        interpret=interpret,
        name="marglik_bwd",
    )(*args)
    # log_norm enters additively: d out / d log_norm = identity.
    return (jnp.zeros_like(obs), jnp.zeros_like(inv_var), g,
            dloT[:, :T].T, dhiT[:, :T].T, dlogw[:T], jnp.zeros_like(maskf))


@functools.lru_cache(maxsize=16)
def _make_fused(interpret: bool, tiles: Tiles):
    @jax.custom_vjp
    def f(obs, inv_var, log_norm, lo, hi, logw, maskf):
        return _fwd(obs, inv_var, log_norm, lo, hi, logw, maskf,
                    interpret, tiles)[0]

    f.defvjp(
        lambda *a: _fwd(*a, interpret, tiles),
        functools.partial(_bwd, interpret, tiles),
    )
    return f


def fused_log_marginals(
    obs: Array,      # [S, B]
    inv_var: Array,  # [S, B]
    log_norm: Array, # [S]
    lo: Array,       # [T, B]
    hi: Array,       # [T, B]
    logw: Array,     # [T]
    maskf: Array,    # [T] float {0, 1}
    interpret: bool = False,
    tiles: Tiles = TILES,
) -> Array:
    """Per-star log marginal cluster likelihood [S], fused.  Matches
    likelihood.ms_star_log_marginals with the table pieces passed
    explicitly; differentiable w.r.t. log_norm, lo, hi and logw.
    `interpret` runs the Pallas interpreter (tests on the CPU)."""
    args = (obs, inv_var, log_norm, lo, hi, logw, maskf)
    # Under shard_map every input must vary over the same mesh axes as
    # the kernel's outputs (the pcast's transpose sums the cotangents of
    # replicated inputs across the axes).
    vma = frozenset().union(*(jax.typeof(x).vma for x in args))
    args = tuple(
        x if jax.typeof(x).vma == vma
        else lax.pcast(x, tuple(vma - jax.typeof(x).vma), to="varying")
        for x in args
    )
    return _make_fused(bool(interpret), tiles)(*args)
