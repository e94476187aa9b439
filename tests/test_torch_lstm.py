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

In ``train`` mode (Alg. 1, the ``paper`` device model's ``TrainNoise``)
each step also draws one ramp ``z`` from the step's ``k_g`` (both ramps
take it), replayed after the gate draw; the train-noise thresholds agree
with the reference's within a few ulps, not bitwise
(``tests/test_torch_train_noise.py``).  ``jax.grad`` of the mean NLL is
held against ``torch.autograd`` at rtol 2e-4 / atol 2e-5
(``test_model_train_grad_parity``'s tolerance), and the per-step LSTM
outputs must show no code flip: an entry more than 1e-4 apart (an NL-ADC
step moves an output by a good part of an LSB, 1/32 of the ramp's range;
rounding alone stays below 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.configs import ptb_lstm as JCFG
from repro.core import analog_layer as JAL
from repro.core import backend as JBK
from repro.core import nladc as JN
from repro.core.analog_layer import AnalogConfig as JAnalog
from repro.data import pipeline as JDATA
from repro.nn import lstm as JL
from repro_torch import convert
from repro_torch.configs import ptb_lstm as TCFG
from repro_torch.core import backend as TBK
from repro_torch.core.analog_layer import AnalogConfig as TAnalog
from repro_torch.core.analog_layer import analog_matmul_act
from repro_torch.core.crossbar import GeneratorNoise, ReplayNoise
from repro_torch.data import pipeline as TDATA
from repro_torch.nn import lstm as TL

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

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


def _draws(key, params, spec, ramp_shape=None, *, steps=T, fc=True,
           paired=False):
    """The reference's noise draws, in the port's call order: per step the
    gate weights' (from ``k_mm``), the ramp's ``normal(k_g, ramp_shape)``
    when ``ramp_shape`` is given (train mode), the projection's (``k_mm``
    again); then the FC layer's (``k_fc``).  ``paired`` (infer-mode read
    noise per device) makes each weight draw two: the positive device's
    from ``split(k_w)[0]``, then the negative's from ``split(k_w)[1]``."""
    def normal(k, w):
        _, k_w, _ = jax.random.split(k, 3)
        keys = jax.random.split(k_w) if paired else (k_w,)
        return [np.asarray(jax.random.normal(kk, w.shape, jnp.float32))
                for kk in keys]

    k, k_fc = jax.random.split(key)
    out = []
    for _ in range(steps):
        k, k_t = jax.random.split(k)
        k_mm, k_g = jax.random.split(k_t)
        out += normal(k_mm, params["lstm"]["w_gates"])
        if ramp_shape is not None:
            out.append(np.asarray(jax.random.normal(k_g, ramp_shape,
                                                    jnp.float32)))
        if spec.n_proj:
            out += normal(k_mm, params["lstm"]["w_proj"])
    if fc:
        out += normal(k_fc, params["fc"]["w"])
    return out


def ramp_shape(spec):
    """The train-mode ramp draw's shape at the hidden width."""
    acts = TL.make_gate_acts(spec.analog, spec.n_hidden)
    bank = acts[0].bank_for(spec.n_hidden)
    p = acts[0].adc.thresholds.shape[0]
    return (bank.bank_map.n_banks, p) if bank is not None else (p,)


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
        model(xs, all_steps=True).detach().numpy(),
        TL.classifier_apply(pt, xs, ts, model.acts, all_steps=True).numpy())
    gen = torch.Generator().manual_seed(0)
    p0 = TL.classifier_init(gen, ts, SMOKE.n_classes)
    assert p0["lstm"]["w_gates"].shape == pj["lstm"]["w_gates"].shape
    assert p0["lstm"]["w_proj"].shape == pj["lstm"]["w_proj"].shape
    assert p0["fc"]["w"].shape == pj["fc"]["w"].shape
    assert float(p0["lstm"]["w_gates"].abs().max()) <= \
        2.0 / np.sqrt(ts.n_in + ts.out_dim) + 1e-6


def _nll_j(logits, labels):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], -1))


def _dense(thr, width):
    thr = np.asarray(thr.thr if hasattr(thr, "thr") else thr)
    if thr.ndim == 1:
        return thr
    return thr[np.asarray(JN.bank_map_for(width, width // thr.shape[0]).idx)]


def _codes(gates, c_new, sig_thr, tanh_thr):
    """The five NL-ADC codes of one step, (5, B, H): f, a, i, o, c'."""
    def count(x, thr):
        return np.sum(np.asarray(x)[..., None] > thr, axis=-1)
    hf, ha, hi, ho = np.split(np.asarray(gates), 4, axis=-1)
    return np.stack([count(hf, sig_thr), count(ha, tanh_thr),
                     count(hi, sig_thr), count(ho, sig_thr),
                     count(c_new, tanh_thr)])


def _reference_codes(js, acts_j, pj, xs, key):
    """Every step's codes in the reference, from ``lstm_cell``'s own pieces
    under ``jax.jit``, scanned over time with ``lstm_scan``'s key splits
    (one compiled step: an unrolled loop gives the same codes and
    compiles T copies of it)."""
    sig, tnh = acts_j
    width = js.n_hidden

    def run(p, x):
        k, _ = jax.random.split(key)
        h = jnp.zeros((x.shape[0], js.out_dim))
        c = jnp.zeros((x.shape[0], width))

        def step(carry, x_t):
            h, c, k = carry
            k, k_t = jax.random.split(k)
            k_mm, k_g = jax.random.split(k_t)
            gates = JAL.analog_matmul_act(
                jnp.concatenate([x_t, h], -1), p["lstm"]["w_gates"],
                js.analog, key=k_mm)
            st, tt = (a.thresholds_for(k_g, width) for a in acts_j)
            h, c = JBK.get_backend("ref").lstm_gates(
                gates, c, sig.adc, tnh.adc, sig_thr=st, tanh_thr=tt)
            out = (gates, c, st.thr if hasattr(st, "thr") else st,
                   tt.thr if hasattr(tt, "thr") else tt)
            h = JAL.analog_matmul_act(h, p["lstm"]["w_proj"], js.analog,
                                      key=k_mm)
            return (h, c, k), out

        return jax.lax.scan(step, (h, c, k), jnp.swapaxes(x, 0, 1))[1]

    gates, c_new, st, tt = jax.jit(run)(pj, jnp.asarray(xs))
    return [_codes(gates[t], c_new[t], _dense(st[t], width),
                   _dense(tt[t], width)) for t in range(gates.shape[0])]


def _recording_tail(monkeypatch):
    """Record the codes of every ``lstm_gates`` call on the ref backend."""
    seen = []
    orig = TBK.RefBackend._lstm_tail

    def tail(self, gates, c, sig_thr, tanh_thr, sig_adc, tanh_adc):
        h, c_new = orig(self, gates, c, sig_thr, tanh_thr, sig_adc, tanh_adc)
        width = c.shape[-1]
        st, tt = (_dense(t.detach(), width) if not hasattr(t, "thr")
                  else _dense(t.thr.detach(), width)
                  for t in (sig_thr, tanh_thr))
        seen.append(_codes(gates.detach(), c_new.detach(), st, tt))
        return h, c_new

    monkeypatch.setattr(TBK.RefBackend, "_lstm_tail", tail)
    return seen


@pytest.mark.parametrize("bank_cols", (0, 16))
@pytest.mark.parametrize("all_steps", (True, False))
def test_train_mode_gradients_match(bank_cols, all_steps, monkeypatch):
    """Alg. 1 gradients of the whole classifier on the ``paper`` model,
    every draw (weights per site, ramp z per step) replayed; the code-flip
    count compares every step's five codes with the reference's."""
    js, ts = _specs("train", device="paper", bank_cols=bank_cols)
    pj = JL.classifier_init(jax.random.PRNGKey(5), js, SMOKE.n_classes)
    rng = np.random.default_rng(11 + bank_cols)
    xs = rng.normal(0, 0.6, (B, T, js.n_in)).astype(np.float32)
    shape = (B, T) if all_steps else (B,)
    labels = rng.integers(0, SMOKE.n_classes, shape)
    key = jax.random.PRNGKey(200 + bank_cols)
    acts_j = JL.make_gate_acts(js.analog, js.n_hidden)

    def loss(p, x, y):
        return _nll_j(JL.classifier_apply(p, x, js, acts_j, key=key,
                                          all_steps=all_steps), y)

    want_l, want_g = jax.jit(jax.value_and_grad(loss))(
        pj, jnp.asarray(xs), jnp.asarray(labels))
    want_codes = _reference_codes(js, acts_j, pj, xs, key)

    model = TL.LSTMClassifier(ts, SMOKE.n_classes,
                              params=convert.params_from_jax(
                                  jax.tree_util.tree_map(np.asarray, pj)))
    noise = ReplayNoise(_draws(key, pj, js, ramp_shape(ts)))
    got_codes = _recording_tail(monkeypatch)
    logits = model(torch.from_numpy(xs), noise=noise, all_steps=all_steps)
    assert noise.remaining == 0
    logp = torch.log_softmax(logits, -1)
    lt = -logp.gather(-1, torch.from_numpy(labels)[..., None]).mean()
    lt.backward()
    flips = sum(int(np.count_nonzero(g != w))
                for g, w in zip(got_codes, want_codes))
    assert len(got_codes) == len(want_codes) == T
    assert flips == 0, flips
    np.testing.assert_allclose(lt.item(), float(want_l), rtol=1e-5)
    for got, want in ((model.w_gates.grad, want_g["lstm"]["w_gates"]),
                      (model.w_proj.grad, want_g["lstm"]["w_proj"]),
                      (model.fc_w.grad, want_g["fc"]["w"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)
        assert float(got.abs().max()) > 0


def test_train_mode_moves_weights_and_ir_stages_run():
    # train mode constructs, draws its noise and moves the weights
    _, ts = _specs("train", device="paper")
    model = TL.LSTMClassifier(ts, SMOKE.n_classes,
                              generator=torch.Generator().manual_seed(0))
    xs = torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.6, (B, T, ts.n_in)).astype(np.float32))
    before = model.w_gates.detach().clone()
    logits = model(xs, noise=GeneratorNoise(torch.Generator().manual_seed(1)),
                   all_steps=True)
    logits.logsumexp(-1).mean().backward()
    with torch.no_grad():
        model.w_gates -= 0.1 * model.w_gates.grad
    assert float(model.w_gates.grad.abs().max()) > 0
    assert not torch.equal(model.w_gates.detach(), before)
    # the circuit-level stages run (paired noise, IR drop, I-V): one pair
    # of draws per weight, and the stages move the read
    _, ts = _specs("infer", device="stressed-ir")
    x = torch.full((2, 4), 0.5)
    w = torch.full((4, 4), 0.5)
    noise = ReplayNoise([np.zeros((4, 4), np.float32)] * 2)
    y = analog_matmul_act(x, w, ts.analog, noise=noise)
    assert noise.remaining == 0
    ideal = analog_matmul_act(x, w, ts.analog.replace(
        device=ts.analog.device.replace(line=None, nonlinear_iv=None)),
        noise=ReplayNoise([np.zeros((4, 4), np.float32)] * 2))
    assert torch.isfinite(y).all() and not torch.equal(y, ideal)


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
    np.testing.assert_array_equal(jc._stream, tc._stream)
    np.testing.assert_array_equal(jc.embeddings(), tc.embeddings())
    for step in (0, 10_000):
        a, b = jc.batch_at(step), tc.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    (jx, jy), (jxt, jyt) = JDATA.SyntheticKWS(seed=1).splits(32, 16)
    (tx, ty), (txt, tyt) = TDATA.SyntheticKWS(seed=1).splits(32, 16)
    for a, b in ((jx, tx), (jy, ty), (jxt, txt), (jyt, tyt)):
        np.testing.assert_array_equal(a, b)
