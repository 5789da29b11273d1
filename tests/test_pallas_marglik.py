"""Fused-marginal kernel parity against the jnp path (forward and VJP),
run through the Pallas interpreter on the CPU (SURVEY.md §4.2
golden-parity strategy: pallas(x) ~= jnp(x) over random batches), plus
the wrapper's layout (padding, run split) and the platform dispatch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from base_tpu.model import likelihood as lk
from base_tpu.model.stardata import make_ms_stars
from base_tpu.ops import pallas_marglik as pm
from base_tpu.ops.pallas_marglik import Tiles, fused_log_marginals

# Small tiles so CPU-sized problems still take several programs, runs
# and loop trips.
SMALL = Tiles(s=8, t=16, t_tiles_per_program=2)


def _random_problem(rng, S=37, T=133, B=8):
    model_mags = rng.normal(12.0, 3.0, (T + 1, B)).astype(np.float32)
    lo = model_mags[:-1]
    hi = lo + rng.normal(0.0, 0.3, (T, B)).astype(np.float32)
    # observations near random table rows so some weights are O(1)
    pick = rng.integers(0, T, S)
    obs = lo[pick] + rng.normal(0, 0.05, (S, B)).astype(np.float32)
    sig = np.abs(rng.normal(0.05, 0.02, (S, B))).astype(np.float32) + 0.01
    sig[rng.random((S, B)) < 0.1] = -9.0  # unobserved bands
    stars = make_ms_stars(obs, sig)
    logw = rng.normal(-2.0, 1.0, T).astype(np.float32)
    mask = (rng.random(T) > 0.15).astype(np.float32)
    table = lk.SegmentTable(
        lo=jnp.asarray(lo), hi=jnp.asarray(hi),
        logw=jnp.asarray(logw), mask=jnp.asarray(mask) > 0.5,
    )
    return stars, table


def _jnp_ref(stars, table):
    return lk.ms_star_log_marginals(stars, table)


def _pallas(stars, table, tiles=pm.TILES):
    return fused_log_marginals(
        stars.obs_mags, stars.inv_var, stars.log_norm,
        table.lo, table.hi, table.logw,
        table.mask.astype(jnp.float32), interpret=True, tiles=tiles,
    )


def _assert_fwd(got, want):
    sel = want > -200  # compare where float32 has real precision
    assert sel.sum() >= max(1, sel.size // 2)
    # Same erf polynomial on both sides; the kernel sums per tile with a
    # running max, so only float32 reassociation separates them.
    np.testing.assert_allclose(got[sel], want[sel], rtol=0, atol=5e-2)


def _grads(f, stars, table, g):
    def loss(lo, hi, logw, ln):
        st = dataclasses.replace(stars, log_norm=ln)
        t = lk.SegmentTable(lo=lo, hi=hi, logw=logw, mask=table.mask)
        return jnp.sum(f(st, t) * g)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        table.lo, table.hi, table.logw, stars.log_norm)


def _assert_grads(got, want):
    for w, gt, name in zip(want, got, ["lo", "hi", "logw", "log_norm"]):
        w = np.asarray(w)
        gt = np.asarray(gt)
        scale = np.abs(w).max() + 1e-6
        # analytic truncated-Gaussian moments vs autodiff through the
        # erf polynomial: ~1e-4 relative, well inside what the HMC
        # accept step absorbs.
        np.testing.assert_allclose(
            gt / scale, w / scale, atol=5e-3, err_msg=name
        )


@pytest.mark.parametrize("split", [False, True])
def test_forward_parity_contraction_forms(rng, split):
    """The segment axis contracted in one run per star tile and split
    over several runs merged by log-sum-exp must both match the jnp
    path, and each other to float32 reassociation."""
    stars, table = _random_problem(rng, S=64, T=128)
    tiles = Tiles(s=16, t=16, t_tiles_per_program=2 if split else 8)
    assert pm._layout(64, 128, tiles)[2] == (4 if split else 1)
    want = np.asarray(_jnp_ref(stars, table))
    got = np.asarray(_pallas(stars, table, tiles))
    _assert_fwd(got, want)
    one = np.asarray(_pallas(stars, table, Tiles(s=16, t=16,
                                                 t_tiles_per_program=8)))
    sel = want > -200
    np.testing.assert_allclose(got[sel], one[sel], rtol=0, atol=1e-4)


def test_forward_parity(rng):
    stars, table = _random_problem(rng)
    _assert_fwd(np.asarray(_pallas(stars, table, SMALL)),
                np.asarray(_jnp_ref(stars, table)))


def test_forward_parity_tile_multiple(rng):
    # Exact tile-size shapes (no padding path) with the shipped tiles.
    stars, table = _random_problem(rng, S=64, T=512)
    _assert_fwd(np.asarray(_pallas(stars, table)),
                np.asarray(_jnp_ref(stars, table)))


@pytest.mark.parametrize("S,T,B", [(5, 40, 3), (17, 75, 5), (33, 130, 8)])
def test_forward_parity_padding(rng, S, T, B):
    """Star, segment and band counts that are not tile multiples (nor
    powers of two): padded stars and segments must not leak."""
    stars, table = _random_problem(rng, S=S, T=T, B=B)
    Sp, Tp, _, _ = pm._layout(S, T, SMALL)
    assert Sp > S and Tp > T
    _assert_fwd(np.asarray(_pallas(stars, table, SMALL)),
                np.asarray(_jnp_ref(stars, table)))


def test_vjp_parity(rng):
    stars, table = _random_problem(rng, S=23, T=67)
    g = rng.normal(0, 1.0, 23).astype(np.float32)
    want = _grads(_jnp_ref, stars, table, g)
    got = _grads(lambda s, t: _pallas(s, t, SMALL), stars, table, g)
    _assert_grads(got, want)


@pytest.mark.parametrize("S,T,B", [(9, 50, 3), (20, 140, 6)])
def test_vjp_parity_padding(rng, S, T, B):
    stars, table = _random_problem(rng, S=S, T=T, B=B)
    g = rng.normal(0, 1.0, S).astype(np.float32)
    want = _grads(_jnp_ref, stars, table, g)
    got = _grads(lambda s, t: _pallas(s, t, SMALL), stars, table, g)
    _assert_grads(got, want)


def test_vmap_over_tables(rng):
    """Chains carry different tables (params differ); the kernel must
    vmap over (lo, hi, logw) with shared photometry."""
    stars, table = _random_problem(rng, S=17, T=45)
    C = 3
    los = jnp.stack([table.lo + 0.01 * i for i in range(C)])
    his = jnp.stack([table.hi + 0.01 * i for i in range(C)])

    def one(lo, hi):
        return fused_log_marginals(
            stars.obs_mags, stars.inv_var, stars.log_norm,
            lo, hi, table.logw, table.mask.astype(jnp.float32),
            interpret=True, tiles=SMALL,
        )

    got = np.asarray(jax.vmap(one)(los, his))
    for i in range(C):
        t = lk.SegmentTable(lo=los[i], hi=his[i], logw=table.logw,
                            mask=table.mask)
        _assert_fwd(got[i], np.asarray(_jnp_ref(stars, t)))


def test_vmap_value_and_grad_over_tables(rng):
    """The HMC shape: value_and_grad vmapped over chains' tables."""
    stars, table = _random_problem(rng, S=12, T=40, B=4)
    C = 2
    los = jnp.stack([table.lo + 0.02 * i for i in range(C)])
    g = rng.normal(0, 1.0, 12).astype(np.float32)

    def make(f):
        def loss(lo):
            t = lk.SegmentTable(lo=lo, hi=table.hi, logw=table.logw,
                                mask=table.mask)
            return jnp.sum(f(stars, t) * g)
        return jax.vmap(jax.value_and_grad(loss))

    v_ref, g_ref = make(_jnp_ref)(los)
    v_got, g_got = make(lambda s, t: _pallas(s, t, SMALL))(los)
    np.testing.assert_allclose(np.asarray(v_got), np.asarray(v_ref),
                               rtol=1e-4)
    for i in range(C):
        _assert_grads([g_got[i]], [g_ref[i]])


def test_all_masked_table_matches_reference(rng):
    """A table with no valid segment gives the jnp path's sentinel."""
    stars, table = _random_problem(rng, S=6, T=20, B=3)
    table = table._replace(mask=jnp.zeros_like(table.mask))
    got = np.asarray(_pallas(stars, table, SMALL))
    want = np.asarray(_jnp_ref(stars, table))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _lowered_text(platform):
    rng = np.random.default_rng(0)
    stars, table = _random_problem(rng, S=8, T=32, B=3)
    f = jax.jit(jax.grad(lambda lo: jnp.sum(lk.ms_log_marginals(
        stars, table._replace(lo=lo)))))
    return f.trace(table.lo).lower(lowering_platforms=(platform,)).as_text()


def test_dispatch_cpu_lowers_plain_path():
    """Compiled for the CPU, the marginal is the plain jnp path: no
    Pallas kernel reaches the program."""
    text = _lowered_text("cpu")
    assert "triton" not in text and "marglik" not in text


def test_dispatch_cuda_lowers_triton_kernel():
    """Lowered for CUDA (no card needed), the same function carries the
    forward and backward kernels through the Triton route."""
    text = _lowered_text("cuda")
    assert text.count("triton") >= 2
    assert "marglik_fwd" in text and "marglik_bwd" in text
