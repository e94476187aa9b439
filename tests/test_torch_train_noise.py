"""Train-mode noise: the per-call ramp thresholds and the weights' train
noise against the JAX package under ``jax.jit``, with the reference's own
standard-normal draws replayed.

The ramp: ``sort(v_init + cumsum(steps + sigma_us * z * g_scale))``.  The
port sums with ``torch.cumsum`` in float32.  The jitted reference is not
bitwise reproducible from ``z``: XLA folds ``sqrt(2) * sigma_us * g_scale``
into one constant inside its normal draw (it never rounds ``z`` itself),
may contract the add into a fused multiply-add, and sums the prefix in
rows of 16 (its reduce-window rewrite).  Measured over 300 keys at 3, 4
and 5 bits, sigmoid and tanh, flat and banked: at most 6 float32 ulps of
the ramp's largest level |V_k| (the prefix sums run up to twice that
magnitude, so this is 3 ulps of a partial sum).  The bound held here is
8 ulps of max |V_k|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.analog_layer import AnalogActivation as JAct
from repro.core.analog_layer import AnalogConfig as JAnalog
from repro.core.analog_layer import _noisy_weights as j_noisy_weights
from repro_torch.core import backend as TBK
from repro_torch.core.analog_layer import AnalogActivation as TAct
from repro_torch.core.analog_layer import AnalogConfig as TAnalog
from repro_torch.core.analog_layer import _noisy_weights as t_noisy_weights
from repro_torch.core.crossbar import NoiseSource, ReplayNoise
from repro_torch.nn import lstm as TL

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

ULP_BOUND = 8
WIDTH = 32


def _cfgs(bits, bank_cols, device="paper"):
    kw = dict(enabled=True, adc_bits=bits, input_bits=bits, mode="train",
              device=device, bank_cols=bank_cols)
    return JAnalog(**kw), TAnalog(**kw)


def _ulps(got, want, ramp):
    return float(np.max(np.abs(got - want))
                 / np.spacing(np.float32(np.max(np.abs(ramp.thresholds)))))


@pytest.mark.parametrize("bank_cols", [0, 16])
@pytest.mark.parametrize("bits", [3, 4, 5])
@pytest.mark.parametrize("name", ["sigmoid", "tanh"])
def test_ramp_noise_matches_jitted_reference(name, bits, bank_cols):
    jc, tc = _cfgs(bits, bank_cols)
    ja, ta = JAct(name, jc), TAct(name, tc)

    def thr(key):
        out = ja.thresholds_for(key, WIDTH)
        return out.thr if bank_cols else out

    fn = jax.jit(thr)
    worst = 0.0
    for seed in range(40):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(fn(key))
        z = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
        got = ta.thresholds_for(WIDTH, noise=ReplayNoise([z]))
        if bank_cols:
            assert got.bank_map.n_banks == want.shape[0] == 2
            got = got.thr
        got = got.numpy()
        assert np.all(np.diff(got, axis=-1) >= 0)         # sorted
        assert not np.array_equal(got, np.sort(ta.adc.thresholds.numpy()))
        worst = max(worst, _ulps(got, want, ta.adc.ramp))
    assert worst <= ULP_BOUND, worst


def test_infer_and_exact_modes_draw_no_ramp_noise():
    for mode in ("exact", "infer"):
        act = TAct("sigmoid", TAnalog(enabled=True, mode=mode,
                                      device="paper"))
        noise = ReplayNoise([])
        assert act.ramp_noise(noise, WIDTH) is None
        assert act.thresholds_for(WIDTH, noise) is act.adc.thresholds


class _Recording(NoiseSource):
    """Standard normals from a seeded generator, each draw kept."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)
        self.draws = []

    def normal(self, shape, device):
        z = torch.randn(tuple(shape), generator=self.gen)
        self.draws.append(z)
        return z


@pytest.mark.parametrize("bank_cols", [0, 16])
def test_one_ramp_draw_per_step_feeds_sigmoid_and_tanh(bank_cols,
                                                       monkeypatch):
    """Per step the cell draws gate-weight noise, one ramp z, then the
    projection's noise; the sigmoid and tanh thresholds are both made from
    that z."""
    _, tc = _cfgs(5, bank_cols)
    spec = TL.LSTMSpec(n_in=8, n_hidden=WIDTH, n_proj=16, analog=tc)
    acts = TL.make_gate_acts(tc, WIDTH)
    p = TL.lstm_init(torch.Generator().manual_seed(0), spec)
    seen = []
    ref = TBK.get_backend("ref")
    orig = type(ref).lstm_gates

    def spy(self, gates, c, sig_adc, tanh_adc, sig_thr=None, tanh_thr=None):
        seen.append((sig_thr, tanh_thr))
        return orig(self, gates, c, sig_adc, tanh_adc, sig_thr, tanh_thr)

    monkeypatch.setattr(type(ref), "lstm_gates", spy)
    noise = _Recording(3)
    steps = 3
    TL.lstm_scan(p, torch.zeros((2, steps, 8)), spec, acts, noise=noise)
    shapes = [tuple(z.shape) for z in noise.draws]
    ramp_shape = (2, 32) if bank_cols else (32,)
    assert shapes == [tuple(p["w_gates"].shape), ramp_shape,
                      tuple(p["w_proj"].shape)] * steps
    for t, (sig_thr, tanh_thr) in enumerate(seen):
        z = noise.draws[3 * t + 1]
        for act, thr in zip(acts, (sig_thr, tanh_thr)):
            want = act.thresholds_for(WIDTH, z=z)
            got = thr.thr if bank_cols else thr
            assert torch.equal(got, want.thr if bank_cols else want)


def test_train_weight_noise_matches_reference_and_passes_the_gradient():
    jc, tc = _cfgs(5, 0)
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1.2, (24, 40)).astype(np.float32)
    w[0, :4] = [2.0, -2.0, 2.5, -3.0]
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda v: j_noisy_weights(v, jc, key))(
        jnp.asarray(w)))
    z = np.asarray(jax.random.normal(key, w.shape, jnp.float32))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = t_noisy_weights(wt, tc, ReplayNoise([z]))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    assert not np.array_equal(got.detach().numpy(), np.clip(w, -2, 2))
    jgrad = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(j_noisy_weights(v, jc, key) ** 2)))(
            jnp.asarray(w)))
    (got * got).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), jgrad, rtol=1e-5, atol=1e-5)
    # the clip's gradient at +-2.0 is 0.5, outside it 0
    assert wt.grad[0, 2] == 0.0 and wt.grad[0, 3] == 0.0
