"""repro_torch's NL-ADC core against the JAX package's, bitwise.

Ramps are host-side float64 numpy in both packages, so their tables must
be identical.  The comparator count is the strict ``n = #{V_k < x}``;
inputs placed exactly on float32 thresholds check that a hit does not
cross.  PWM quantization rounds half to even in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nladc as JN
from repro_torch.core import nladc as TN
from repro_torch.kernels import ref as TREF

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

ACTS = ("sigmoid", "tanh", "gelu", "selu")


@pytest.mark.parametrize("bits", (3, 4, 5))
@pytest.mark.parametrize("name", ACTS)
def test_ramp_tables_bitwise(name, bits):
    a, b = JN.build_ramp(name, bits), TN.build_ramp(name, bits)
    for field in ("thresholds", "y_table", "steps"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (a.v_init, a.split_index, a.monotonic_split) == \
        (b.v_init, b.split_index, b.monotonic_split)
    assert a.g_scale == b.g_scale
    np.testing.assert_array_equal(a.conductances_us(), b.conductances_us())


def test_nonmonotonic_extra_points_and_conductance_rebuild():
    a = JN.build_nonmonotonic_ramp("gelu", 5, extra_negative_points=3)
    b = TN.build_nonmonotonic_ramp("gelu", 5, extra_negative_points=3)
    np.testing.assert_array_equal(a.y_table, b.y_table)
    np.testing.assert_array_equal(a.thresholds, b.thresholds)
    g = np.random.default_rng(3).uniform(0, 150, a.steps.shape)
    ra = JN.ramp_from_conductances(a, g)
    rb = TN.ramp_from_conductances(b, g)
    np.testing.assert_array_equal(ra.thresholds, rb.thresholds)
    assert JN.inl_lsb(ra, a) == TN.inl_lsb(rb, b)


def _inputs(ramp, rng, n=4096):
    """Gaussian inputs plus every float32 threshold, exactly."""
    thr32 = np.asarray(ramp.thresholds, np.float32)
    x = rng.normal(0, 2.5, n).astype(np.float32)
    x[: thr32.size] = thr32
    return x.reshape(-1, 64)


@pytest.mark.parametrize("name", ACTS)
def test_codes_and_values_bitwise(name, rng):
    ramp = JN.build_ramp(name, 5)
    x = _inputs(ramp, rng)
    jadc, tadc = JN.NLADC(ramp), TN.NLADC(TN.build_ramp(name, 5))
    want_codes = np.asarray(jadc.codes(jnp.asarray(x)))
    got_codes = tadc.codes(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got_codes, want_codes)
    want = np.asarray(JN._nladc_fwd_impl(jnp.asarray(x), jadc.thresholds,
                                         jadc.y_table))
    np.testing.assert_array_equal(tadc(torch.from_numpy(x)).numpy(), want)
    # an input exactly on a threshold does not cross it
    thr32 = np.asarray(ramp.thresholds, np.float32)
    on = tadc.codes(torch.from_numpy(thr32)).numpy()
    np.testing.assert_array_equal(on, np.searchsorted(thr32, thr32, "left"))
    # the kernels' explicit count is the same strict comparator
    cnt = TREF.thermometer_count(torch.from_numpy(x), tadc.thresholds)
    np.testing.assert_array_equal(cnt.numpy(), want_codes)
    np.testing.assert_array_equal(TN.nladc_reference(x, ramp),
                                  JN.nladc_reference(x, ramp))


@pytest.mark.parametrize("width,tile_cols", [(64, 16), (50, 16), (64, 64)])
def test_banked_codes_bitwise(width, tile_cols, rng):
    ramp = JN.build_ramp("tanh", 5)
    bm_j = JN.bank_map_for(width, tile_cols)
    bm_t = TN.bank_map_for(width, tile_cols)
    np.testing.assert_array_equal(bm_j.idx, bm_t.idx)
    assert bm_j.n_banks == bm_t.n_banks
    # every bank a shifted copy of the ramp, as programming noise would
    shift = rng.normal(0, 0.05, (bm_t.n_banks, 1))
    thr = (ramp.thresholds[None, :] + shift).astype(np.float32)
    x = rng.normal(0, 1.5, (6, width)).astype(np.float32)
    x[0] = thr[bm_t.idx, np.arange(width) % thr.shape[1]]   # exact hits
    want = np.asarray(JN._banked_count(jnp.asarray(x), jnp.asarray(thr),
                                       bm_j))
    banked = TN.BankedThresholds(torch.from_numpy(thr), bm_t)
    got = TN.nladc_banked_codes(torch.from_numpy(x), banked).numpy()
    np.testing.assert_array_equal(got, want)
    cnt = TREF.thermometer_count(torch.from_numpy(x), banked.per_column)
    np.testing.assert_array_equal(cnt.numpy(), want)


def test_bank_map_rejects_bad_tiles_and_widths():
    with pytest.raises(ValueError):
        TN.bank_map_for(8, 0)
    banked = TN.BankedThresholds(torch.zeros(2, 4), TN.bank_map_for(8, 4))
    with pytest.raises(ValueError, match="columns"):
        TN.nladc_banked_codes(torch.zeros(3, 9), banked)


@pytest.mark.parametrize("bits,x_max", [(5, 1.0), (4, 2.0), (3, 0.5)])
def test_pwm_quantize_bitwise(bits, x_max, rng):
    levels = (1 << bits) - 2
    step = np.float32(2.0 * x_max / levels)
    x = rng.normal(0, x_max, 4096).astype(np.float32)
    # exact half-way points: round half to even must agree
    x[:64] = ((np.arange(64) - 32) + 0.5).astype(np.float32) * step
    want = np.asarray(jax.jit(lambda v: JN.pwm_quantize(v, bits, x_max))(
        jnp.asarray(x)))
    got = TN.pwm_quantize(torch.from_numpy(x), bits, x_max).numpy()
    np.testing.assert_array_equal(got, want)


def test_degeneracy_warning_matches():
    thr = np.array([0.1, 0.1 + 1e-12, 0.5])
    with pytest.warns(TN.DegenerateThresholdWarning):
        assert TN.check_threshold_degeneracy(thr, "x") == 1
    with pytest.warns(JN.DegenerateThresholdWarning):
        assert JN.check_threshold_degeneracy(thr, "x") == 1
