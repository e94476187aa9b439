"""The slice as a whole: repro_torch's analog LSTM classifier against the
JAX package's ``classifier_apply`` (under ``jax.jit``), at the PTB SMOKE
widths (n_in 16, hidden 32, projection 16, 50 classes; T 8, B 4), with
the same weights through ``params_from_jax``.

In ``infer`` mode the read-noise draws are replayed from the reference's
own key tree, in its split order: ``classifier_apply`` -> ``lstm_scan``
(one split per step) -> ``lstm_cell`` (``k_mm, k_g``) ->
``analog_matmul_act`` (``k_in, k_w, k_act``), where the projection reuses
the step's ``k_mm`` and the FC layer takes ``k_fc``.

Tolerances: the float32 matmul sums in another order in XLA and in
PyTorch, and XLA fuses ``w + sigma*z`` into one multiply-add, so the noisy
weights and the gate pre-activations may differ in the last bits; a
pre-activation within an ulp of a threshold could then flip an NL-ADC code
and move an output by an LSB.  Measured over seeds 0-3 of every case
below: quantized exact mode was bitwise equal, infer mode differed by at
most 3.0e-8 with no code flip (flip fraction 0), and the float baseline by
at most 8.9e-8.  The logits are held to rtol 1e-5 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.configs import ptb_lstm as JCFG
from repro.core.analog_layer import AnalogConfig as JAnalog
from repro.data import pipeline as JDATA
from repro.nn import lstm as JL
from repro_torch import convert
from repro_torch.configs import ptb_lstm as TCFG
from repro_torch.core.analog_layer import AnalogConfig as TAnalog
from repro_torch.core.analog_layer import analog_matmul_act
from repro_torch.core.crossbar import GeneratorNoise, ReplayNoise
from repro_torch.data import pipeline as TDATA
from repro_torch.nn import lstm as TL

B, T = 4, 8
SMOKE = JCFG.SMOKE
RTOL = ATOL = 1e-5


def _specs(mode, enabled=True, device="paper-infer", bank_cols=0):
    kw = dict(enabled=enabled, adc_bits=5, input_bits=5, mode=mode,
              device=device, bank_cols=bank_cols)
    dims = dict(n_in=SMOKE.n_input_features, n_hidden=SMOKE.lstm_hidden,
                n_proj=SMOKE.lstm_proj)
    return (JL.LSTMSpec(analog=JAnalog(**kw), **dims),
            TL.LSTMSpec(analog=TAnalog(**kw), **dims))


def _draws(key, params, spec):
    """The reference's read-noise draws, in the port's call order."""
    def normal(k, w):
        _, k_w, _ = jax.random.split(k, 3)
        return np.asarray(jax.random.normal(k_w, w.shape, jnp.float32))

    k, k_fc = jax.random.split(key)
    out = []
    for _ in range(T):
        k, k_t = jax.random.split(k)
        k_mm, _ = jax.random.split(k_t)
        out.append(normal(k_mm, params["lstm"]["w_gates"]))
        if spec.n_proj:
            out.append(normal(k_mm, params["lstm"]["w_proj"]))
    out.append(normal(k_fc, params["fc"]["w"]))
    return out


def _run(mode, enabled=True, bank_cols=0, all_steps=True, seed=0):
    js, ts = _specs(mode, enabled, bank_cols=bank_cols)
    pj = JL.classifier_init(jax.random.PRNGKey(seed), js, SMOKE.n_classes)
    xs = np.random.default_rng(seed).normal(
        0, 0.6, (B, T, js.n_in)).astype(np.float32)
    key = jax.random.PRNGKey(100 + seed) if mode == "infer" else None
    acts_j = JL.make_gate_acts(js.analog, js.n_hidden)
    fn = jax.jit(lambda p, x: JL.classifier_apply(
        p, x, js, acts_j, key=key, all_steps=all_steps))
    want = np.asarray(fn(pj, jnp.asarray(xs)))

    pt = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    acts_t = TL.make_gate_acts(ts.analog, ts.n_hidden)
    noise = ReplayNoise(_draws(key, pj, js)) if key is not None else None
    got = TL.classifier_apply(pt, torch.from_numpy(xs), ts, acts_t,
                              noise=noise, all_steps=all_steps).numpy()
    if noise is not None:
        assert noise.remaining == 0
    return got, want


@pytest.mark.parametrize("enabled", (False, True))
def test_exact_mode_matches(enabled):
    got, want = _run("exact", enabled)
    assert got.shape == (B, T, SMOKE.n_classes)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bank_cols", (0, 16))
@pytest.mark.parametrize("all_steps", (True, False))
def test_infer_mode_matches_with_replayed_noise(bank_cols, all_steps):
    got, want = _run("infer", bank_cols=bank_cols, all_steps=all_steps)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_noise_changes_the_output_and_replay_checks_shapes():
    js, ts = _specs("infer")
    pj = JL.classifier_init(jax.random.PRNGKey(0), js, SMOKE.n_classes)
    pt = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    acts = TL.make_gate_acts(ts.analog, ts.n_hidden)
    xs = torch.from_numpy(np.random.default_rng(1).normal(
        0, 0.6, (B, T, ts.n_in)).astype(np.float32))
    outs = []
    for seed in (1, 2):
        gen = torch.Generator().manual_seed(seed)
        outs.append(TL.classifier_apply(pt, xs, ts, acts,
                                        noise=GeneratorNoise(gen)))
    assert not torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="shape"):
        TL.classifier_apply(pt, xs, ts, acts,
                            noise=ReplayNoise([np.zeros((2, 2))]))
    with pytest.raises(IndexError):
        TL.classifier_apply(pt, xs, ts, acts, noise=ReplayNoise([]))


def test_module_and_npz_round_trip(tmp_path):
    js, ts = _specs("exact")
    pj = JL.classifier_init(jax.random.PRNGKey(3), js, SMOKE.n_classes)
    path = tmp_path / "params.npz"
    convert.save_npz(path, pj)
    pt = convert.load_npz(path)
    for group, leaves in pj.items():
        for name, v in leaves.items():
            np.testing.assert_array_equal(pt[group][name].numpy(),
                                          np.asarray(v))
    model = TL.LSTMClassifier(ts, SMOKE.n_classes, params=pt)
    xs = torch.zeros((2, 3, ts.n_in))
    np.testing.assert_array_equal(
        model(xs, all_steps=True).numpy(),
        TL.classifier_apply(pt, xs, ts, model.acts, all_steps=True).numpy())
    gen = torch.Generator().manual_seed(0)
    p0 = TL.classifier_init(gen, ts, SMOKE.n_classes)
    assert p0["lstm"]["w_gates"].shape == pj["lstm"]["w_gates"].shape
    assert p0["lstm"]["w_proj"].shape == pj["lstm"]["w_proj"].shape
    assert p0["fc"]["w"].shape == pj["fc"]["w"].shape
    assert float(p0["lstm"]["w_gates"].abs().max()) <= \
        2.0 / np.sqrt(ts.n_in + ts.out_dim) + 1e-6


def test_unported_modes_and_stages_raise():
    with pytest.raises(NotImplementedError, match="train"):
        TAnalog(mode="train")
    _, ts = _specs("infer", device="stressed-ir")
    w = torch.zeros((4, 4))
    with pytest.raises(NotImplementedError):
        analog_matmul_act(torch.zeros(2, 4), w, ts.analog,
                          noise=GeneratorNoise(torch.Generator()))


def test_configs_match():
    for name in ("kws_lstm", "ptb_lstm"):
        assert vars(JC.get(name)).keys() == vars(TC.get(name)).keys()
        for get in ("get", "get_smoke"):
            j, t = getattr(JC, get)(name), getattr(TC, get)(name)
            for field in j.__dict__:
                if field != "analog":
                    assert getattr(j, field) == getattr(t, field), field
            assert vars(j.analog) == vars(t.analog)
            assert j.n_params() == t.n_params()
    assert TCFG.CONFIG.lstm_hidden == 2016 and TCFG.CONFIG.lstm_proj == 504


def test_data_pipelines_match():
    jc = JDATA.CharCorpus(seq_len=32, batch=4, corpus_len=4000, seed=3)
    tc = TDATA.CharCorpus(seq_len=32, batch=4, corpus_len=4000, seed=3)
    np.testing.assert_array_equal(jc.embeddings(), tc.embeddings())
    for step in (0, 10_000):
        a, b = jc.batch_at(step), tc.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    (jx, jy), (jxt, jyt) = JDATA.SyntheticKWS(seed=1).splits(32, 16)
    (tx, ty), (txt, tyt) = TDATA.SyntheticKWS(seed=1).splits(32, 16)
    for a, b in ((jx, tx), (jy, ty), (jxt, txt), (jyt, tyt)):
        np.testing.assert_array_equal(a, b)
