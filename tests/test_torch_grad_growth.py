"""Alg. 1 gradients of the PTB classifier through 128 time steps: the port
against the JAX reference (``jax.jit(jax.value_and_grad)``), on fig5c's
data (the synthetic char corpus's orthogonal embeddings, batch 0, B 16,
T 128), the ``paper`` device model in train mode, the reference's initial
weights (``convert.params_from_jax``) and every draw replayed from its key
tree (``test_torch_lstm._draws``).

The tests hold the SMOKE widths (hidden 32, projection 16), flat and
banked (16 columns), at ``test_model_train_grad_parity``'s tolerance
(rtol 2e-4, atol 2e-5), with the port handed the reference's own noisy
thresholds of every step, as ``test_torch_lstm_train.py`` does: computed
from the replayed ``z`` they agree only within a few ulps
(``test_torch_train_noise.py``), and over 128 steps the banked case meets
one pre-activation inside that gap; its flipped code moves 5 of the 800
FC gradients by up to 3.2e-5 (28%), while the flat case still agrees
within 3e-7.  Wider networks are not held to a tolerance: there such
flips (of the thresholds, and of the summation orders) spread through
time.  How far is measured against the port's own sensitivity: the same
port run with ``w_gates`` moved by one ulp.

Run as a script, the file prints one JSON line per width (hidden, then
projection = hidden / 4, as the PTB config's 2016 / 504), with the
largest |dL/dw| per weight in the reference and in the port, their
largest difference over the reference's largest, and that of the
one-ulp-perturbed port run against the port's, all from the replayed
``z`` (``--ref-thresholds`` hands the port the reference's)::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_grad_growth.py \
        [--widths 32,128,504,1008,1512] [--bank-cols N] [--ref-thresholds]
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import CharCorpus
from repro.nn import lstm as JL
from repro_torch import convert
from repro_torch.core.crossbar import ReplayNoise
from repro_torch.nn import lstm as TL
from test_torch_lstm import JAnalog, TAnalog, _draws, _nll_j, ramp_shape
from test_torch_lstm_train import _reference_thresholds, _replay_thresholds

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

B, T, N_IN, N_CLASSES = 16, 128, 128, 50
NAMES = (("lstm", "w_gates"), ("lstm", "w_proj"), ("fc", "w"))


def _port_grads(ts, pt, xs, labels, draws, perturb=False):
    if perturb:
        w = pt["lstm"]["w_gates"]
        pt = {**pt, "lstm": {**pt["lstm"], "w_gates": torch.nextafter(
            w, torch.full_like(w, float("inf")))}}
    model = TL.LSTMClassifier(ts, N_CLASSES, params=pt)
    noise = ReplayNoise(draws)
    logits = model(torch.from_numpy(xs), noise=noise, all_steps=True)
    assert noise.remaining == 0
    logp = torch.log_softmax(logits, -1)
    loss = -logp.gather(-1, torch.from_numpy(labels)[..., None]).mean()
    loss.backward()
    grads = {"w_gates": model.w_gates.grad, "w_proj": model.w_proj.grad,
             "w": model.fc_w.grad}
    return loss.item(), {k: g.numpy() for k, g in grads.items()}


def ptb_gradients(hidden, proj, bank_cols=0, *, seed=0, perturb=False,
                  ref_thresholds=False):
    """(loss, grads) of the reference and of the port at one width; with
    ``perturb`` also the port's with ``w_gates`` one ulp up; with
    ``ref_thresholds`` the port takes the reference's noisy thresholds."""
    kw = dict(enabled=True, adc_bits=5, input_bits=5, mode="train",
              device="paper", bank_cols=bank_cols)
    js = JL.LSTMSpec(analog=JAnalog(**kw), n_in=N_IN, n_hidden=hidden,
                     n_proj=proj)
    ts = TL.LSTMSpec(analog=TAnalog(**kw), n_in=N_IN, n_hidden=hidden,
                     n_proj=proj)
    corpus = CharCorpus(seq_len=T, batch=B, corpus_len=60_000)
    batch = corpus.batch_at(0)
    xs = corpus.embeddings()[batch["tokens"]].astype(np.float32)
    labels = batch["labels"].astype(np.int64)
    pj = JL.classifier_init(jax.random.PRNGKey(seed), js, N_CLASSES)
    key = jax.random.PRNGKey(seed + 1)
    acts = JL.make_gate_acts(js.analog, hidden)

    def loss(p, x, y):
        return _nll_j(JL.classifier_apply(p, x, js, acts, key=key,
                                          all_steps=True), y)

    want_l, want_g = jax.jit(jax.value_and_grad(loss))(
        pj, jnp.asarray(xs), jnp.asarray(labels))
    want = {k: np.asarray(want_g[g][k]) for g, k in NAMES}
    pt = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    draws = _draws(key, pj, js, ramp_shape(ts), steps=T)
    out = {"ref": (float(want_l), want)}
    runs = {"port": False, "port_ulp": True} if perturb else {"port": False}
    with pytest.MonkeyPatch.context() as mp:
        queue = []
        if ref_thresholds:
            _replay_thresholds(mp, queue)
        for run, ulp in runs.items():
            if ref_thresholds:
                queue[:] = _reference_thresholds(js, acts, key, T)
            out[run] = _port_grads(ts, pt, xs, labels, draws, ulp)
            assert not queue
    return out


@pytest.mark.parametrize("bank_cols", (0, 16))
def test_ptb_gradients_match_over_128_steps(bank_cols):
    out = ptb_gradients(32, 16, bank_cols, ref_thresholds=True)
    want_l, want = out["ref"]
    got_l, got = out["port"]
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    for name, w in want.items():
        assert np.all(np.isfinite(got[name])), name
        np.testing.assert_allclose(got[name], w, rtol=2e-4, atol=2e-5,
                                   err_msg=name)
        assert float(np.abs(got[name]).max()) > 0, name


def _summary(hidden, bank_cols, out):
    want_l, want = out["ref"]
    row = {"hidden": hidden, "proj": hidden // 4, "bank_cols": bank_cols,
           "B": B, "T": T, "loss_ref": want_l}
    for run in ("port", "port_ulp"):
        loss, got = out[run]
        row[f"loss_{run}"] = loss
        for name, w in want.items():
            g = got[name]
            row[f"{name}_max_{run}"] = float(np.abs(g).max())
            base = out["port"][1][name] if run == "port_ulp" else w
            row[f"{name}_rel_diff_{run}"] = float(
                np.abs(g - base).max() / np.abs(base).max())
    for name, w in want.items():
        row[f"{name}_max_ref"] = float(np.abs(w).max())
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="32,128,504,1008,1512")
    ap.add_argument("--bank-cols", type=int, default=0)
    ap.add_argument("--ref-thresholds", action="store_true")
    args = ap.parse_args(argv)
    for hidden in map(int, args.widths.split(",")):
        out = ptb_gradients(hidden, hidden // 4, args.bank_cols,
                            perturb=True, ref_thresholds=args.ref_thresholds)
        print(json.dumps(_summary(hidden, args.bank_cols, out)), flush=True)


if __name__ == "__main__":
    main()
