"""Alg. 1 training through the IR correction of weights that span several
crossbar tiles, the correction recomputed in the backward.

* A classifier whose gate weight spans two crossbars of the paper's 633x512
  tiling (n_in 16, hidden 160, projection 16: ``w_gates`` is (32, 640),
  tiles of 512 and 128 columns), B 2 x T 4, on ``paper-ir`` and
  ``stressed-ir``, flat and with 128-column banks: ``torch.autograd``
  against ``jax.grad`` of the mean NLL of the reference under ``jax.jit``,
  every draw replayed from the reference's key tree, within rtol 2e-4 /
  atol 2e-5 (``test_model_train_grad_parity``'s tolerance), no code flip.
* The recomputing backward (``analog_layer._noisy_weights`` runs the
  correction under ``torch.utils.checkpoint``) gives the same gradients as
  the correction's own graph, bit for bit, on one matrix of four tile
  shapes and on the whole classifier.
* ``torch.autograd.graph.saved_tensors_hooks`` counts the bytes autograd
  keeps for one IR call and the matmul that reads its output: at most two
  copies of the weight (its input and the effective weight) plus the
  matmul's input, where the correction's own graph keeps more than ten.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.analog_layer import AnalogConfig as JAnalog
from repro.nn import lstm as JL
from repro_torch import convert
from repro_torch.core import analog_layer as TAL
from repro_torch.core import crossbar as TCB
from repro_torch.core import device as TD
from repro_torch.core.analog_layer import AnalogConfig as TAnalog
from repro_torch.core.crossbar import GeneratorNoise, ReplayNoise
from repro_torch.nn import lstm as TL
from test_torch_lstm import (_draws, _nll_j, _recording_tail,
                             _reference_codes, ramp_shape)

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

B, T = 2, 4
N_IN, HIDDEN, PROJ, CLASSES = 16, 160, 16, 50
IR_PRESETS = ("paper-ir", "stressed-ir")


def _specs(preset, bank_cols=0):
    kw = dict(enabled=True, adc_bits=5, input_bits=5, mode="train",
              device=preset, bank_cols=bank_cols)
    dims = dict(n_in=N_IN, n_hidden=HIDDEN, n_proj=PROJ)
    return (JL.LSTMSpec(analog=JAnalog(**kw), **dims),
            TL.LSTMSpec(analog=TAnalog(**kw), **dims))


def _model(ts, pj):
    return TL.LSTMClassifier(ts, CLASSES, params=convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, pj)))


def _loss(model, xs, labels, noise):
    logits = model(torch.from_numpy(xs), noise=noise, all_steps=True)
    logp = torch.log_softmax(logits, -1)
    return -logp.gather(-1, torch.from_numpy(labels)[..., None]).mean()


def test_the_gate_weight_spans_several_crossbars():
    assert TCB.plan_tiles(N_IN + PROJ, 4 * HIDDEN).n_crossbars == 2


@pytest.mark.parametrize("bank_cols", (0, 128))
@pytest.mark.parametrize("preset", IR_PRESETS)
def test_multi_tile_train_gradients_match_jax(preset, bank_cols,
                                              monkeypatch):
    js, ts = _specs(preset, bank_cols)
    pj = JL.classifier_init(jax.random.PRNGKey(13), js, CLASSES)
    rng = np.random.default_rng(31 + bank_cols)
    xs = rng.normal(0, 0.6, (B, T, N_IN)).astype(np.float32)
    labels = rng.integers(0, CLASSES, (B, T))
    key = jax.random.PRNGKey(700 + bank_cols)
    acts_j = JL.make_gate_acts(js.analog, js.n_hidden)

    def loss(p, x, y):
        return _nll_j(JL.classifier_apply(p, x, js, acts_j, key=key,
                                          all_steps=True), y)

    want_l, want_g = jax.jit(jax.value_and_grad(loss))(
        pj, jnp.asarray(xs), jnp.asarray(labels))
    want_codes = _reference_codes(js, acts_j, pj, xs, key)

    model = _model(ts, pj)
    noise = ReplayNoise(_draws(key, pj, js, ramp_shape(ts), steps=T))
    got_codes = _recording_tail(monkeypatch)
    lt = _loss(model, xs, labels, noise)
    assert noise.remaining == 0
    lt.backward()
    assert len(got_codes) == len(want_codes) == T
    assert sum(int(np.count_nonzero(g != w))
               for g, w in zip(got_codes, want_codes)) == 0
    np.testing.assert_allclose(lt.item(), float(want_l), rtol=1e-5)
    for got, want in ((model.w_gates.grad, want_g["lstm"]["w_gates"]),
                      (model.w_proj.grad, want_g["lstm"]["w_proj"]),
                      (model.fc_w.grad, want_g["fc"]["w"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)
        assert float(got.abs().max()) > 0


def _without_recompute(fn, *args, **kw):
    """``torch.utils.checkpoint.checkpoint``'s call, run directly."""
    return fn(*args)


@pytest.mark.parametrize("sourcing,r", [("single", 1.0), ("double", 2.5)])
def test_recomputed_correction_is_bitwise_the_direct_one(sourcing, r):
    """Full tiles, a partial column strip, a partial row strip and the
    corner (700 x 600 on 633 x 512 tiles): value and gradient of
    ``_noisy_weights`` (no noise drawn) against clip + the correction."""
    cfg = TAnalog(mode="train", device=TD.DeviceModel(
        name="line", line=TD.LineResistance(r_wl_ohm=r, r_bl_ohm=r,
                                            sourcing=sourcing)))
    rng = np.random.default_rng(5)
    w0 = torch.from_numpy(rng.normal(0, 0.8, (700, 600)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(0, 1.0, (700, 600)).astype(np.float32))
    outs, grads = [], []
    for fn in (lambda w: TAL._noisy_weights(w, cfg, None),
               lambda w: TCB.ir_effective_weights_tiled(
                   TCB.clip_weights(w), r, r, sourcing, 2)):
        w = w0.clone().requires_grad_(True)
        out = fn(w)
        out.backward(ct)
        outs.append(out.detach())
        grads.append(w.grad)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(grads[0], grads[1])
    assert float(grads[0].abs().max()) > 0


@pytest.mark.parametrize("preset", IR_PRESETS)
def test_recompute_on_and_off_give_the_same_gradients(preset, monkeypatch):
    _, ts = _specs(preset)
    gen = torch.Generator().manual_seed(4)
    params = TL.classifier_init(gen, ts, CLASSES)
    rng = np.random.default_rng(8)
    xs = rng.normal(0, 0.6, (B, T, N_IN)).astype(np.float32)
    labels = rng.integers(0, CLASSES, (B, T))
    grads = []
    for recompute in (True, False):
        if not recompute:
            monkeypatch.setattr(TAL, "checkpoint", _without_recompute)
        model = TL.LSTMClassifier(ts, CLASSES, params=params)
        _loss(model, xs, labels,
              GeneratorNoise(torch.Generator().manual_seed(9))).backward()
        grads.append([p.grad for p in (model.w_gates, model.w_proj,
                                       model.fc_w)])
    for on, off in zip(*grads):
        assert torch.equal(on, off)


def _saved_bytes(fn):
    """Bytes of the distinct tensors autograd saves while ``fn`` runs."""
    seen = {}

    def pack(t):
        seen[(t.data_ptr(), t.dtype, tuple(t.shape))] = \
            t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


@pytest.mark.parametrize("preset", IR_PRESETS)
def test_one_ir_call_saves_at_most_two_copies_of_the_weight(preset,
                                                             monkeypatch):
    """``w_gates`` at (32, 640) (two tiles), through ``_noisy_weights``
    with no noise and the clip taken out: the correction's input and the
    matmul's effective weight, plus the matmul's input (x), against more
    than ten copies where the correction's own graph is kept."""
    _, ts = _specs(preset)
    monkeypatch.setattr(TCB, "clip_weights", lambda w: w)
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(0, 0.5, (N_IN + PROJ, 4 * HIDDEN))
                         .astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.normal(0, 0.5, (B, N_IN + PROJ))
                         .astype(np.float32))
    w_bytes, x_bytes = w.numel() * 4, x.numel() * 4

    def run():
        noisy = w + 0.01          # a fresh tensor, as each step's is
        return x @ TAL._noisy_weights(noisy, ts.analog, None)

    kept = _saved_bytes(run)
    assert kept <= 2 * w_bytes + x_bytes, kept / w_bytes
    monkeypatch.setattr(TAL, "checkpoint", _without_recompute)
    assert _saved_bytes(run) > 10 * w_bytes
