"""The step-time crossbar forms that no LSTM path calls (write noise,
stuck-at-OFF, paired write noise, the noisy VMM and Supp. S10's phased
read) against ``repro.core.crossbar``, every draw replayed from the
reference's keys in the reference's order:

* ``write_noise_weights``: ``normal(key, w.shape)``;
* ``stuck_at_off``: ``uniform(key, w.shape)``, the mask ``u < p`` as
  ``jax.random.bernoulli`` compares it: bitwise;
* ``write_noise_weights_paired``: the positive devices' ``normal`` from
  ``split(key)[0]``, then the negative's from ``split(key)[1]``;
* ``noisy_vmm``: ``normal(key, w.shape)``; ``phased_vmm``: one
  ``normal(split(key, n_chunks)[i], (chunk, n_out))`` per chunk, in chunk
  order, the last chunk zero-padded.

The noise forms are held to rtol 1e-6 / atol 1e-7 against eager JAX (the
same float32 multiply-add; against jitted XLA the paired form agrees only
within rtol 1e-5, ``tests/test_torch_ir.py``); the VMMs to rtol and atol
1e-6 against jitted JAX (the PWM rounding as ``jax.jit`` compiles it:
``tests/test_torch_pwm.py``; the sum order differs).  ``phased_vmm``
without noise equals one VMM, as ``tests/test_crossbar.py`` holds the
reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import crossbar as JCB
from repro_torch.core import crossbar as TCB
from repro_torch.core.crossbar import GeneratorNoise, ReplayNoise

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

RTOL_NOISE, ATOL_NOISE = 1e-6, 1e-7
TOL_VMM = 1e-6


def _w(shape, seed, scale=1.0):
    w = np.random.default_rng(seed).normal(0, scale, shape)
    w.flat[:3] = (0.0, 1.99, -2.5)
    return w.astype(np.float32)


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


@pytest.mark.parametrize("sigma_w", [JCB.WRITE_SIGMA_W, 0.5])
def test_write_noise_weights(sigma_w):
    w = _w((24, 40), 0)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JCB.write_noise_weights(key, jnp.asarray(w), sigma_w))
    noise = ReplayNoise([_normal(key, w.shape)])
    got = TCB.write_noise_weights(noise, torch.from_numpy(w), sigma_w)
    assert noise.remaining == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_NOISE,
                               atol=ATOL_NOISE)
    assert float(got.abs().max()) <= TCB.W_CLIP
    assert TCB.WRITE_SIGMA_W == JCB.WRITE_SIGMA_W


@pytest.mark.parametrize("prob", [0.02, 0.3, 1.0])
def test_stuck_at_off_bitwise(prob):
    w = _w((33, 70), 1)
    key = jax.random.PRNGKey(11)
    want = np.asarray(JCB.stuck_at_off(key, jnp.asarray(w), prob))
    u = np.asarray(jax.random.uniform(key, w.shape, jnp.float32))
    noise = ReplayNoise([u])
    got = TCB.stuck_at_off(noise, torch.from_numpy(w), prob)
    assert noise.remaining == 0
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.count_nonzero(want == 0) > 3


def test_stuck_at_off_without_faults_draws_nothing():
    w = torch.ones(4, 4)
    noise = ReplayNoise([])
    assert TCB.stuck_at_off(noise, w, 0.0) is w
    got = TCB.stuck_at_off(GeneratorNoise(torch.Generator().manual_seed(0)),
                           torch.ones(200, 200), 0.25)
    assert 0.2 < float((got == 0).float().mean()) < 0.3


@pytest.mark.parametrize("sigma_w", [JCB.WRITE_SIGMA_W, 0.2])
def test_write_noise_weights_paired(sigma_w):
    w = _w((24, 40), 2)
    key = jax.random.PRNGKey(5)
    want = np.asarray(JCB.write_noise_weights_paired(key, jnp.asarray(w),
                                                     sigma_w))
    k_p, k_n = jax.random.split(key)
    noise = ReplayNoise([_normal(k_p, w.shape), _normal(k_n, w.shape)])
    got = TCB.write_noise_weights_paired(noise, torch.from_numpy(w), sigma_w)
    assert noise.remaining == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_NOISE,
                               atol=ATOL_NOISE)


@pytest.mark.parametrize("input_bits,sigma", [(None, 0.0), (5, 0.0),
                                              (3, JCB.READ_SIGMA_W),
                                              (None, 0.1)])
def test_noisy_vmm(input_bits, sigma):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.5, (6, 40)).astype(np.float32)
    w = _w((40, 24), 3, 0.3)
    key = jax.random.PRNGKey(8) if sigma else None
    want = np.asarray(jax.jit(lambda x, w: JCB.noisy_vmm(
        x, w, key=key, read_sigma_w=sigma, input_bits=input_bits))(
            jnp.asarray(x), jnp.asarray(w)))
    noise = ReplayNoise([_normal(key, w.shape)] if sigma else [])
    got = TCB.noisy_vmm(torch.from_numpy(x), torch.from_numpy(w),
                        noise=noise, read_sigma_w=sigma,
                        input_bits=input_bits)
    assert noise.remaining == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_VMM, atol=TOL_VMM)


@pytest.mark.parametrize("n_in,active,input_bits,sigma", [
    (70, 16, None, 0.0), (70, 16, 5, JCB.READ_SIGMA_W), (64, 16, 4, 0.1),
    (633, 256, 5, JCB.READ_SIGMA_W)])
def test_phased_vmm(n_in, active, input_bits, sigma):
    rng = np.random.default_rng(n_in)
    x = rng.normal(0, 0.5, (3, n_in)).astype(np.float32)
    w = _w((n_in, 24), 6, 0.3)
    jplan = JCB.plan_tiles(n_in, 24, max_active_rows=active)
    tplan = TCB.plan_tiles(n_in, 24, max_active_rows=active)
    key = jax.random.PRNGKey(21) if sigma else None
    want = np.asarray(jax.jit(lambda x, w: JCB.phased_vmm(
        x, w, jplan, key=key, read_sigma_w=sigma, input_bits=input_bits))(
            jnp.asarray(x), jnp.asarray(w)))
    n_chunks = -(-n_in // active)
    draws = [_normal(k, (active, 24))
             for k in jax.random.split(key, n_chunks)] if sigma else []
    noise = ReplayNoise(draws)
    got = TCB.phased_vmm(torch.from_numpy(x), torch.from_numpy(w), tplan,
                         noise=noise, read_sigma_w=sigma,
                         input_bits=input_bits)
    assert noise.remaining == 0
    assert got.shape == (3, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_VMM, atol=TOL_VMM)


def test_phased_vmm_exact_equals_plain(rng):
    """``tests/test_crossbar.py::test_phased_vmm_exact_equals_plain`` on
    the port: the paper's 633 rows in 3 phases equal one VMM."""
    x = torch.from_numpy(rng.normal(0, 1, (4, 633)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.1, (633, 64)).astype(np.float32))
    plan = TCB.plan_tiles(633, 64)
    assert plan.n_phases == 3
    np.testing.assert_allclose(TCB.phased_vmm(x, w, plan).numpy(),
                               (x @ w).numpy(), rtol=2e-3, atol=2e-3)


def test_read_noise_needs_a_source():
    x, w = torch.ones(2, 4), torch.ones(4, 3)
    with pytest.raises(ValueError, match="NoiseSource"):
        TCB.noisy_vmm(x, w, read_sigma_w=0.1)
    with pytest.raises(ValueError, match="NoiseSource"):
        TCB.phased_vmm(x, w, TCB.plan_tiles(4, 3), read_sigma_w=0.1)
