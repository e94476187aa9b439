"""repro_torch's circuit-level crossbar stages against the JAX package's
(``repro.core.crossbar``, under ``jax.jit``) and against a float64 numpy
evaluation of the same formulas.

* IR drop (``line_drop``, ``line_attenuation``, ``ir_effective_weights``,
  ``ir_effective_weights_tiled``): within 32 float32 ulps of float64 (ulps
  taken at the float64 value; both the port and jitted JAX measure a few)
  and within rtol 4e-6 of jitted JAX; r = 0 is the identity, bitwise.
  The tiled form's batched groups equal the per-tile loop bitwise, and
  its gradient matches ``jax.grad`` at rtol 1e-5 / atol 1e-7.
* ``ramp_series_attenuation`` and the pair mappings: host numpy, bitwise.
* ``nonlinear_iv_read``: bitwise the jitted reference (XLA folds the
  constants in float32 and contracts ``v + (c3*v*v)*v`` into one FMA).
* Paired read noise on the reference's replayed draws: ``allclose`` at
  rtol 1e-5 / atol 1e-6 (jitted XLA folds ``sqrt(2)*sigma`` into its
  normal draw, so no replay is bitwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crossbar as JCB
from repro_torch.core import crossbar as TCB
from repro_torch.core.crossbar import ReplayNoise

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

ULPS = 32
RTOL_JAX = 4e-6
SOURCING = ("single", "double")
# a partial-tile matrix: row tiles 16, 16, 8; col tiles 24, 24, 22
SHAPE, TILE = (40, 70), (16, 24)


def _w(shape, seed=0, scale=0.5):
    w = np.random.default_rng(seed).normal(0, scale, shape)
    w.flat[:3] = (0.0, 2.5, -3.0)       # a zero pair and two clipped ones
    return w.astype(np.float32)


def _plans(shape, tile):
    if tile is None:
        return None, None
    return (JCB.plan_tiles(*shape[-2:], *tile),
            TCB.plan_tiles(*shape[-2:], *tile))


# -- a float64 oracle, written out in numpy -----------------------------------

def _drop64(g_us, r_wl, r_bl, sourcing):
    g = g_us * 1e-6
    n_rows, n_cols = g.shape[-2:]
    j = np.arange(n_cols, dtype=np.float64)
    i = np.arange(n_rows, dtype=np.float64)[:, None]
    # the kernel sums written as explicit double sums over j' and i'
    lo = np.minimum(j[:, None], j[None, :])
    hi = np.maximum(j[:, None], j[None, :])
    if sourcing == "single":
        k_wl = lo + 1.0
    else:
        k_wl = (lo + 1.0) * (n_cols - hi) / (n_cols + 1.0)
    k_bl = n_rows - np.maximum(i, i.T)
    return r_wl * g @ k_wl.T + r_bl * k_bl @ g


def _ir64(w, r, sourcing, n_iter, tile=None):
    w = np.clip(np.asarray(w, np.float64), -2.0, 2.0)
    if r == 0.0:
        return w
    out = np.empty_like(w)
    tr, tc = tile or w.shape
    for r0 in range(0, w.shape[0], tr):
        for c0 in range(0, w.shape[1], tc):
            blk = w[r0:r0 + tr, c0:c0 + tc]
            eff = 0.0
            for sign in (1.0, -1.0):
                g = 75.0 * np.maximum(sign * blk, 0.0)
                s = 1.0 / (1.0 + _drop64(g, r, r, sourcing))
                for _ in range(n_iter):
                    s = 1.0 / (1.0 + _drop64(g * s, r, r, sourcing))
                eff = eff + sign * g * s / 75.0
            out[r0:r0 + tr, c0:c0 + tc] = eff
    return out


def _ulps(got, want64):
    spacing = np.spacing(np.abs(want64).astype(np.float32)).astype(np.float64)
    return float(np.max(np.abs(got.astype(np.float64) - want64) / spacing))


def _jax_tiled(w, r, sourcing, n_iter, plan):
    return np.asarray(jax.jit(lambda w: JCB.ir_effective_weights_tiled(
        w, r, r, sourcing, n_iter, plan))(jnp.asarray(w)))


# -- IR drop -------------------------------------------------------------------

@pytest.mark.parametrize("sourcing", SOURCING)
@pytest.mark.parametrize("r", (0.5, 2.5))
def test_line_drop_and_attenuation(sourcing, r):
    g = 75.0 * np.abs(_w((24, 40), seed=1)).astype(np.float32)
    for n_iter in (0, 2):
        want = np.asarray(jax.jit(lambda g: JCB.line_attenuation(
            g, r, r, sourcing, n_iter))(jnp.asarray(g)))
        got = TCB.line_attenuation(torch.from_numpy(g), r, r, sourcing,
                                   n_iter).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL_JAX)
    d = TCB.line_drop(torch.from_numpy(g).double(), r, r, sourcing).numpy()
    np.testing.assert_allclose(d, _drop64(g.astype(np.float64), r, r,
                                          sourcing), rtol=1e-12)
    d32 = TCB.line_drop(torch.from_numpy(g), r, r, sourcing).numpy()
    np.testing.assert_allclose(d32, np.asarray(jax.jit(
        lambda g: JCB.line_drop(g, r, r, sourcing))(jnp.asarray(g))),
        rtol=RTOL_JAX)


@pytest.mark.parametrize("n_iter", (0, 2))
@pytest.mark.parametrize("r", (0.0, 0.5, 1.0, 2.5))
@pytest.mark.parametrize("sourcing", SOURCING)
def test_ir_tiled_against_jax_and_float64(sourcing, r, n_iter):
    w = _w(SHAPE)
    jplan, tplan = _plans(SHAPE, TILE)
    wt = torch.from_numpy(w)
    got = TCB.ir_effective_weights_tiled(wt, r, r, sourcing, n_iter, tplan)
    if r == 0.0:
        assert got is wt
        return
    got = got.numpy()
    want = _jax_tiled(w, r, sourcing, n_iter, jplan)
    want64 = _ir64(w, r, sourcing, n_iter, TILE)
    assert got.dtype == np.float32
    assert _ulps(got, want64) <= ULPS
    assert _ulps(want, want64) <= ULPS
    np.testing.assert_allclose(got, want, rtol=RTOL_JAX, atol=0)
    assert got.flat[0] == 0.0


@pytest.mark.parametrize("sourcing", SOURCING)
def test_ir_single_tile_and_default_plan(sourcing):
    """A matrix within one 633x512 tile takes the single-block path; the
    untiled ``ir_effective_weights`` is the same function on it."""
    w = _w((48, 128), seed=2)
    got = TCB.ir_effective_weights_tiled(torch.from_numpy(w), 1.0, 1.0,
                                         sourcing)
    flat = TCB.ir_effective_weights(torch.from_numpy(w), 1.0, 1.0, sourcing)
    assert torch.equal(got, flat)
    want = np.asarray(jax.jit(lambda w: JCB.ir_effective_weights(
        w, 1.0, 1.0, sourcing))(jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_JAX)
    assert _ulps(got.numpy(), _ir64(w, 1.0, sourcing, 2)) <= ULPS


@pytest.mark.parametrize("sourcing", SOURCING)
def test_ir_stacked_3d(sourcing):
    w = np.stack([_w(SHAPE, seed=s) for s in range(3)])
    jplan, tplan = _plans(SHAPE, TILE)
    got = TCB.ir_effective_weights_tiled(torch.from_numpy(w), 2.5, 2.5,
                                         sourcing, 2, tplan).numpy()
    want = np.asarray(jax.jit(lambda w: JCB.ir_effective_weights_tiled(
        w, 2.5, 2.5, sourcing, 2, jplan))(jnp.asarray(w)))
    assert got.shape == w.shape
    np.testing.assert_allclose(got, want, rtol=RTOL_JAX)
    for m in range(3):
        assert _ulps(got[m], _ir64(w[m], 2.5, sourcing, 2, TILE)) <= ULPS
        # each leading matrix is corrected on its own
        one = TCB.ir_effective_weights_tiled(torch.from_numpy(w[m]), 2.5,
                                             2.5, sourcing, 2, tplan)
        np.testing.assert_array_equal(got[m], one.numpy())


@pytest.mark.parametrize("shape,tile", (
    (SHAPE, TILE),                  # partial rows and columns
    ((48, 72), (16, 24)),           # exact multiples
    ((40, 72), (16, 24)),           # partial rows only
    ((48, 70), (16, 24)),           # partial columns only
    ((40, 70), (40, 24)),           # one row band
    ((40, 70), (16, 70)),           # one column band
))
@pytest.mark.parametrize("sourcing", SOURCING)
def test_batched_groups_equal_the_per_tile_loop(shape, tile, sourcing):
    w = torch.from_numpy(_w(shape, seed=4))
    plan = TCB.plan_tiles(*shape, *tile)
    got = TCB.ir_effective_weights_tiled(w, 1.0, 2.5, sourcing, 2, plan)
    want = w.clone()
    for _, rs, cs in plan.blocks():
        want[rs, cs] = TCB.ir_effective_weights(w[rs, cs], 1.0, 2.5,
                                                sourcing, 2)
    assert torch.equal(got, want)


def test_ir_plan_must_cover_the_matrix():
    w = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="plan covers"):
        TCB.ir_effective_weights_tiled(w, 1.0, 1.0,
                                       plan=TCB.plan_tiles(32, 70, 16, 24))
    with pytest.raises(ValueError, match="sourcing"):
        TCB.line_drop(w, 1.0, 1.0, "triple")


@pytest.mark.parametrize("n_iter", (0, 2))
@pytest.mark.parametrize("sourcing", SOURCING)
def test_ir_gradient_matches_jax_grad(sourcing, n_iter):
    w = _w(SHAPE, seed=5)
    ct = np.random.default_rng(6).normal(0, 1, SHAPE).astype(np.float32)
    jplan, tplan = _plans(SHAPE, TILE)
    want = np.asarray(jax.jit(jax.grad(lambda w: jnp.sum(
        JCB.ir_effective_weights_tiled(w, 2.5, 2.5, sourcing, n_iter, jplan)
        * ct)))(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_(True)
    (TCB.ir_effective_weights_tiled(wt, 2.5, 2.5, sourcing, n_iter, tplan)
     * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), want, rtol=1e-5, atol=1e-7)
    assert float(wt.grad.abs().max()) > 0


# -- host-side helpers ---------------------------------------------------------

@pytest.mark.parametrize("segments", (0.0, 16.0, 32.0))
def test_ramp_series_attenuation_bitwise(segments):
    g = np.random.default_rng(8).uniform(0, 150, (3, 32))
    for r_wl, r_bl in ((1.0, 1.0), (2.5, 0.5)):
        np.testing.assert_array_equal(
            TCB.ramp_series_attenuation(g, r_wl, r_bl, segments),
            JCB.ramp_series_attenuation(g, r_wl, r_bl, segments))


def test_pair_mappings_and_drift_weights_bitwise():
    w = np.random.default_rng(9).normal(0, 1.2, (20, 30))
    pj, pt = JCB.weights_to_conductance_pairs(w), \
        TCB.weights_to_conductance_pairs(w)
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(JCB.conductance_pairs_to_weights(*pj),
                                  TCB.conductance_pairs_to_weights(*pt))
    a = JCB.write_noise_pairs_np(np.random.default_rng(1), *pj, 2.67)
    b = TCB.write_noise_pairs_np(np.random.default_rng(1), *pt, 2.67)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        JCB.DriftModel().drift_weights(w, 86_400.0,
                                       np.random.default_rng(3)),
        TCB.DriftModel().drift_weights(w, 86_400.0,
                                       np.random.default_rng(3)))


def test_tile_plans_match():
    for args in ((632, 8064), (2016, 504), (504, 50), (40, 70, 16, 24),
                 (700, 700, 633, 512, 128)):
        j, t = JCB.plan_tiles(*args), TCB.plan_tiles(*args)
        assert vars(j) == vars(t)
        assert j.n_crossbars == t.n_crossbars
        assert [(ij, rs, cs) for ij, rs, cs in j.blocks()] == \
            [(ij, rs, cs) for ij, rs, cs in t.blocks()]


# -- nonlinear I-V ------------------------------------------------------------

@pytest.mark.parametrize("clip", (1.0, 0.5, 2.0, 0.7))
@pytest.mark.parametrize("alpha", (0.5, 1.0))
def test_nonlinear_iv_read_bitwise(alpha, clip):
    rng = np.random.default_rng(10)
    x = np.concatenate([rng.uniform(-1.3 * clip, 1.3 * clip, 4000),
                        np.linspace(-clip, clip, 63)]).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: JCB.nonlinear_iv_read(
        x, alpha, clip))(jnp.asarray(x)))
    got = TCB.nonlinear_iv_read(torch.from_numpy(x), alpha, clip).numpy()
    np.testing.assert_array_equal(got, want)
    # and with a gradient asked for, the same values
    xt = torch.from_numpy(x).requires_grad_(True)
    np.testing.assert_array_equal(
        TCB.nonlinear_iv_read(xt, alpha, clip).detach().numpy(), want)
    xt = torch.from_numpy(x)
    assert TCB.nonlinear_iv_read(xt, 0.0, clip) is xt


@pytest.mark.parametrize("clip", (1.0, 0.5))
@pytest.mark.parametrize("alpha", (0.5, 1.0))
def test_nonlinear_iv_read_gradient(alpha, clip):
    x = np.random.default_rng(11).uniform(-clip, clip, 500).astype(np.float32)
    ct = np.random.default_rng(12).normal(0, 1, 500).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(
        JCB.nonlinear_iv_read(x, alpha, clip) * ct)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (TCB.nonlinear_iv_read(xt, alpha, clip) * torch.from_numpy(ct)).sum() \
        .backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-7)


# -- paired read noise ---------------------------------------------------------

@pytest.mark.parametrize("sigma_w", (JCB.READ_SIGMA_W, 2 * JCB.READ_SIGMA_W))
def test_paired_read_noise_on_replayed_draws(sigma_w):
    w = _w((48, 128), seed=13, scale=0.8)
    w[0, :8] = (0.0, 1e-3, -1e-3, 2.0, -2.0, 1.99, 0.02, -0.03)
    key = jax.random.PRNGKey(14)
    want = np.asarray(jax.jit(lambda w: JCB.read_noise_weights_paired(
        key, w, sigma_w))(jnp.asarray(w)))
    k_p, k_n = jax.random.split(key)
    draws = [np.asarray(jax.random.normal(k, w.shape, jnp.float32))
             for k in (k_p, k_n)]
    noise = ReplayNoise(draws)
    got = TCB.read_noise_weights_paired(noise, torch.from_numpy(w),
                                        sigma_w).numpy()
    assert noise.remaining == 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the per-device clip at g >= 0: a zero weight reads non-negative
    # noise on each device, so its read has both signs but stays small
    assert np.abs(got[0, 0]) <= 5 * sigma_w
    # and the pairs come back in the positive-then-negative order
    g_pos, g_neg = TCB.noise_conductance_pairs(
        ReplayNoise(draws), torch.zeros(w.shape), torch.zeros(w.shape), 1.0)
    np.testing.assert_array_equal(g_pos.numpy(), np.clip(draws[0], 0, 150))
    np.testing.assert_array_equal(g_neg.numpy(), np.clip(draws[1], 0, 150))
