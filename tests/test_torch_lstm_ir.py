"""The slice as a whole under the circuit-level presets: repro_torch's
analog LSTM classifier against the JAX package's (under ``jax.jit``) on
``paper-ir`` (1 ohm wires, single-side sourcing, I-V alpha 0.5) and
``stressed-ir`` (2.5 ohm, double-side, alpha 1.0, paired per-device
noise, 2% stuck devices, best-of-4 ramps), at the PTB SMOKE widths
(n_in 16, hidden 32, projection 16, 50 classes; T 8, B 4), flat and with
16-column threshold banks.

Infer mode runs on weights aged by each package's own
``DeviceModel.age_params`` (the tiled deployment path), which must agree
bitwise first; the read-noise draws are replayed from the reference's key
tree, per device under ``paired_noise`` (``test_torch_lstm._draws``).
The logits are held to ``test_torch_lstm``'s rtol 1e-5 / atol 1e-5.
Train mode (Alg. 1 on ``paper-ir``, the IR correction and the I-V
transform in the graph) holds ``jax.grad`` of the mean NLL against
``torch.autograd`` at rtol 2e-4 / atol 2e-5.  Both count the NL-ADC code
flips of every step against the reference's codes: none expected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device as JD
from repro.nn import lstm as JL
from repro_torch import convert
from repro_torch.core import device as TD
from repro_torch.core.crossbar import ReplayNoise
from repro_torch.nn import lstm as TL
from test_torch_lstm import (ATOL, RTOL, SMOKE, B, T, _draws, _nll_j,
                             _recording_tail, _reference_codes, _specs,
                             ramp_shape)

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

IR_PRESETS = ("paper-ir", "stressed-ir")


def _flips(got_codes, want_codes):
    assert len(got_codes) == len(want_codes) == T
    return sum(int(np.count_nonzero(g != w))
               for g, w in zip(got_codes, want_codes))


def _aged(preset, pj):
    """Both packages' tiled aging of the same tree, held bitwise."""
    aged_j = JD.get_device(preset).age_params(pj)
    pt = TD.get_device(preset).age_params(
        convert.params_from_jax(jax.tree_util.tree_map(np.asarray, pj)))
    for group, leaves in aged_j.items():
        for name, v in leaves.items():
            np.testing.assert_array_equal(pt[group][name].numpy(),
                                          np.asarray(v))
    return aged_j, pt


@pytest.mark.parametrize("bank_cols", (0, 16))
@pytest.mark.parametrize("preset", IR_PRESETS)
def test_infer_logits_on_aged_weights(preset, bank_cols, monkeypatch):
    js, ts = _specs("infer", device=preset, bank_cols=bank_cols)
    pj0 = JL.classifier_init(jax.random.PRNGKey(3), js, SMOKE.n_classes)
    pj, pt = _aged(preset, pj0)
    assert not np.array_equal(np.asarray(pj["lstm"]["w_gates"]),
                              np.asarray(pj0["lstm"]["w_gates"]))
    xs = np.random.default_rng(7).normal(
        0, 0.6, (B, T, js.n_in)).astype(np.float32)
    key = jax.random.PRNGKey(300 + bank_cols)
    acts_j = JL.make_gate_acts(js.analog, js.n_hidden)
    want = np.asarray(jax.jit(lambda p, x: JL.classifier_apply(
        p, x, js, acts_j, key=key, all_steps=True))(pj, jnp.asarray(xs)))
    want_codes = _reference_codes(js, acts_j, pj, xs, key)

    acts_t = TL.make_gate_acts(ts.analog, ts.n_hidden)
    paired = ts.analog.device.paired_noise
    assert paired == (preset == "stressed-ir")
    noise = ReplayNoise(_draws(key, pj, js, paired=paired))
    got_codes = _recording_tail(monkeypatch)
    got = TL.classifier_apply(pt, torch.from_numpy(xs), ts, acts_t,
                              noise=noise, all_steps=True).numpy()
    assert noise.remaining == 0
    assert got.shape == (B, T, SMOKE.n_classes)
    assert _flips(got_codes, want_codes) == 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bank_cols", (0, 16))
@pytest.mark.parametrize("all_steps", (True, False))
def test_paper_ir_train_gradients(bank_cols, all_steps, monkeypatch):
    """Alg. 1 on ``paper-ir``: the gradient flows through the IR correction
    of every crossbar and through the I-V transform of every input."""
    js, ts = _specs("train", device="paper-ir", bank_cols=bank_cols)
    pj = JL.classifier_init(jax.random.PRNGKey(9), js, SMOKE.n_classes)
    rng = np.random.default_rng(21 + bank_cols)
    xs = rng.normal(0, 0.6, (B, T, js.n_in)).astype(np.float32)
    labels = rng.integers(0, SMOKE.n_classes,
                          (B, T) if all_steps else (B,))
    key = jax.random.PRNGKey(400 + bank_cols)
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
    assert _flips(got_codes, want_codes) == 0
    np.testing.assert_allclose(lt.item(), float(want_l), rtol=1e-5)
    for got, want in ((model.w_gates.grad, want_g["lstm"]["w_gates"]),
                      (model.w_proj.grad, want_g["lstm"]["w_proj"]),
                      (model.fc_w.grad, want_g["fc"]["w"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)
        assert float(got.abs().max()) > 0


def test_ir_changes_the_train_gradient():
    """The correction is in the graph: ``paper-ir`` and ``paper-infer``
    (no line or I-V stage) give different gradients on the same draws."""
    grads = []
    pj = JL.classifier_init(jax.random.PRNGKey(9), _specs("train")[0],
                            SMOKE.n_classes)
    xs = torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.6, (B, T, SMOKE.n_input_features)).astype(np.float32))
    for preset in ("paper-ir", "paper-infer"):
        js, ts = _specs("train", device=preset)
        model = TL.LSTMClassifier(ts, SMOKE.n_classes,
                                  params=convert.params_from_jax(
                                      jax.tree_util.tree_map(np.asarray,
                                                             pj)))
        draws = _draws(jax.random.PRNGKey(1), pj, js, ramp_shape(ts))
        model(xs, noise=ReplayNoise(draws),
              all_steps=True).logsumexp(-1).mean().backward()
        grads.append(model.w_gates.grad.clone())
    assert not torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("config,mode,preset,trains", [
    ("ptb_lstm", "train", "paper-ir", True),
    ("ptb_lstm", "infer", "paper-ir", False),
    ("ptb_lstm", "train", "paper", False),
    ("kws_lstm", "train", "paper-ir", False),
])
def test_trainer_builds_every_preset(config, mode, preset, trains):
    """Every config builds in every mode on every preset, also where a
    weight spans several crossbars under a line stage (PTB on
    ``paper-ir``: the IR correction is recomputed in the backward); PTB
    there also trains one step at its published widths (B 1 x T 2): a
    finite loss, every weight moved."""
    from repro_torch.launch import lstm_train

    analog = lstm_train.analog_config(mode, analog_device=preset)
    model = lstm_train.build_model(config, analog, torch.device("cpu"))
    assert model.w_gates.ndim == 2
    if not trains:
        return
    assert tuple(model.w_gates.shape) == (632, 8064)
    before = [p.detach().clone() for p in (model.w_gates, model.w_proj,
                                           model.fc_w)]
    batches = lstm_train.ptb_train_batches(1, 2, torch.device("cpu"))
    res = lstm_train.train(model, batches, 1, lr=2e-3, all_steps=True)
    assert np.isfinite(res["losses"][0])
    for b, p in zip(before, (model.w_gates, model.w_proj, model.fc_w)):
        assert not torch.equal(b, p.detach())
