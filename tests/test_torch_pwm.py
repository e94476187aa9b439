"""PWM input quantization at the half-step boundaries, against the jitted
reference.

The reference quantizes ``round(clip(x) / step) * step``.  The LSTMs it
evaluates run under ``jax.jit`` (``benchmarks/fig5c_ptb.py``,
``benchmarks/fig4d_kws.py``), and there XLA compiles the division by the
constant step into a multiplication by its float32 reciprocal
(``14.999999`` for 5 bits, not 15).  Eager JAX divides.  The two differ by
one whole PWM step at some float32 inputs next to a half-step, and the
port is held to the jitted function there: every half-step ``(k + 1/2) *
step`` between two codes, rounded to float32, and its neighbours one and
two ulps away on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nladc as JN
from repro_torch.core import nladc as TN


def _boundary_inputs(bits: int, x_max: float) -> np.ndarray:
    """The float32 values at and next to every half-step of the grid."""
    levels = (1 << bits) - 2
    step = 2.0 * x_max / levels
    half = (np.arange(-(levels // 2), levels // 2) + 0.5) * step
    out = []
    for h in half.astype(np.float32):
        v = [h]
        for direction in (np.float32(np.inf), np.float32(-np.inf)):
            u = h
            for _ in range(2):
                u = np.nextafter(u, direction)
                v.append(u)
        out.extend(v)
    return np.asarray(out, np.float32)


def _jitted(bits: int, x_max: float):
    return jax.jit(JN.pwm_quantize, static_argnums=(1, 2)), (bits, x_max)


@pytest.mark.parametrize("bits,n_inputs", [(4, 70), (5, 150), (8, 1270)])
def test_pwm_boundaries_match_jitted_reference(bits, n_inputs):
    x = _boundary_inputs(bits, 1.0)
    assert x.size == n_inputs
    fn, static = _jitted(bits, 1.0)
    want = np.asarray(fn(jnp.asarray(x), *static))
    got = TN.pwm_quantize(torch.from_numpy(x), bits, 1.0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits,x_max", [(3, 0.5), (5, 2.0), (6, 1.5)])
def test_pwm_boundaries_other_clips(bits, x_max):
    x = np.concatenate([_boundary_inputs(bits, x_max),
                        np.float32([-3 * x_max, 3 * x_max, 0.0, -0.0,
                                    x_max, -x_max])])
    fn, static = _jitted(bits, x_max)
    want = np.asarray(fn(jnp.asarray(x), *static))
    got = TN.pwm_quantize(torch.from_numpy(x), bits, x_max).numpy()
    np.testing.assert_array_equal(got, want)


def test_eager_reference_is_not_the_contract():
    """Eager JAX divides, so it differs from the jitted reference (and the
    port) at some of these inputs: the test above would not catch a
    port that divided."""
    x = jnp.asarray(_boundary_inputs(5, 1.0))
    with jax.disable_jit():
        eager = np.asarray(JN.pwm_quantize(x, 5, 1.0))
    fn, static = _jitted(5, 1.0)
    jitted = np.asarray(fn(x, *static))
    assert (eager != jitted).any()
    got = TN.pwm_quantize(torch.from_numpy(np.array(x)), 5, 1.0).numpy()
    np.testing.assert_array_equal(got, jitted)


def test_pwm_constants_are_float32_reciprocals():
    step, recip = TN.pwm_constants(5, 1.0)
    assert step == np.float32(2.0 / 30) and recip == np.float32(14.999999)
    assert recip == np.float32(1.0) / step
