"""The trainer (``repro_torch.launch.lstm_train``) and its optimizer
(``repro_torch.train.optim``) against the JAX package.

* Three Adam steps of ``lstm_train.train_step`` against the step inside
  ``benchmarks/fig5c_ptb.py::train_eval_bpc`` (``value_and_grad`` of the
  mean NLL, then ``optim.Adam.update``, under ``jax.jit``; rebuilt here,
  since the benchmark's is a closure), at the PTB SMOKE widths in train
  mode on the ``paper`` device model, from the same initial weights, with
  the reference's draws replayed: the losses, the gradients' global norms
  (rtol 1e-4) and the parameters after each step within rtol 1e-4 / atol
  1e-5.  The port is handed the reference's
  own per-step noisy thresholds: computed from the replayed ``z`` they
  agree only within a few ulps (``test_torch_train_noise.py``), and one
  pre-activation inside that gap flips a code, which Adam's per-element
  normalization turns into an update up to 2 lr apart (seen once: PTB
  banked, step 0, one o gate).  The thresholds from ``z`` and the code
  flips they leave are held in ``test_torch_lstm.py``
  (``test_train_mode_gradients_match``: 0 flips).
* ``optim.Adam``, ``clip_by_global_norm`` (also ahead of Adam, where the
  reference's Adam clips inside), ``global_norm`` and both schedules
  against ``repro/train/optim.py`` over 5 steps at rtol 1e-6.  The
  moments are held at rtol 1e-6 plus an atol of 1e-6 of the leaf's
  largest moment: ``m' = fma(b1, m, (1-b1)*g)`` cancels
  where g turns against m, and there a one-ulp difference in g (the
  global norm sums in another order) is a large relative one.
* The entry point at a tiny size on the CPU (both configs), and its refusal
  to run without a GPU unless asked for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ptb_lstm as JCFG
from repro.data import pipeline as JDATA
from repro.nn import lstm as JL
from repro.train import optim as JO
from repro_torch import convert
from repro_torch.core.crossbar import ReplayNoise
from repro_torch.launch import lstm_train
from repro_torch.nn import lstm as TL
from repro_torch.train import optim as TO
from test_torch_lstm import _draws, _specs, ramp_shape

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

SMOKE = JCFG.SMOKE
B, T = 4, 8


def _reference_thresholds(js, acts, key, n_steps):
    """The reference's noisy (sigmoid, tanh) thresholds of every step of
    one ``classifier_apply`` with ``key``, in the port's call order."""
    def run(k0):
        k, _ = jax.random.split(k0)
        out = []
        for _ in range(n_steps):
            k, k_t = jax.random.split(k)
            _, k_g = jax.random.split(k_t)
            for act in acts:
                thr = act.thresholds_for(k_g, js.n_hidden)
                out.append(thr.thr if hasattr(thr, "thr") else thr)
        return out
    return [torch.from_numpy(np.array(t)) for t in jax.jit(run)(key)]


def _replay_thresholds(monkeypatch, queue):
    """Hand the port's activations the queued thresholds, in call order."""
    from repro_torch.core import analog_layer as TAL
    from repro_torch.core import nladc as TN

    def thresholds_for(self, width=0, noise=None, *, z=None):
        thr = queue.pop(0)
        if thr.dim() == 2:
            return TN.BankedThresholds(thr, self.bank_for(width).bank_map)
        return thr

    monkeypatch.setattr(TAL.AnalogActivation, "thresholds_for",
                        thresholds_for)


@pytest.mark.parametrize("bank_cols", [0, 16])
def test_three_adam_steps_match_the_reference_loop(bank_cols, monkeypatch):
    js, ts = _specs("train", device="paper", bank_cols=bank_cols)
    corpus = JDATA.CharCorpus(seq_len=T, batch=B, corpus_len=4000)
    # the SMOKE input width: the first 16 coordinates of the 128-dim
    # orthogonal embeddings (one row per char)
    emb_np = np.ascontiguousarray(
        corpus.embeddings()[:, :SMOKE.n_input_features])
    emb = jnp.asarray(emb_np)
    acts = JL.make_gate_acts(js.analog, js.n_hidden)
    params = JL.classifier_init(jax.random.PRNGKey(0), js, SMOKE.n_classes)
    opt = JO.Adam(lr=2e-3)
    state = opt.init(params)

    def loss_fn(p, toks, labels, key):
        logits = JL.classifier_apply(p, emb[toks], js, acts, key=key,
                                     all_steps=True)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, labels[..., None], -1)[..., 0]
        return jnp.mean(nll)

    @jax.jit
    def step(p, s, toks, labels, key):
        l, g = jax.value_and_grad(loss_fn)(p, toks, labels, key)
        p, s = opt.update(g, s, p)
        return p, s, l, JO.global_norm(g)

    model = TL.LSTMClassifier(ts, SMOKE.n_classes,
                              params=convert.params_from_jax(
                                  jax.tree_util.tree_map(np.asarray, params)))
    topt = TO.Adam(lr=2e-3)
    tstate = topt.init(TO.tree_map(torch.Tensor.detach, model.params()))
    emb_t = torch.from_numpy(emb_np)
    rs = ramp_shape(ts)
    queue = []
    _replay_thresholds(monkeypatch, queue)
    key = jax.random.PRNGKey(1)
    for i in range(3):
        b = corpus.batch_at(i)
        key, k = jax.random.split(key)
        params, state, want_loss, want_norm = step(params, state,
                                        jnp.asarray(b["tokens"]),
                                        jnp.asarray(b["labels"]), k)
        noise = ReplayNoise(_draws(k, params, js, rs))
        queue.extend(_reference_thresholds(js, acts, k, T))
        xs = emb_t[torch.from_numpy(b["tokens"].astype(np.int64))]
        labels = torch.from_numpy(b["labels"].astype(np.int64))
        tstate, loss, norm = lstm_train.train_step(
            model, topt, tstate, xs, labels, noise=noise, all_steps=True)
        assert noise.remaining == 0 and not queue
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-4)
        got = model.params()
        for group, leaves in params.items():
            for name, v in leaves.items():
                np.testing.assert_allclose(
                    got[group][name].detach().numpy(), np.asarray(v),
                    rtol=1e-4, atol=1e-5, err_msg=f"step {i} {group}/{name}")
    assert int(tstate.count) == 3


def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"lstm": {"w_gates": (6, 8), "w_proj": (4, 3)},
              "fc": {"w": (3, 5)}}
    return {g: {k: rng.normal(0, 1, s).astype(np.float32)
                for k, s in leaves.items()} for g, leaves in shapes.items()}


def _to_torch(tree):
    return TO.tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _assert_trees_close(got, want, rtol=1e-6, atol=0.0):
    for g, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(got[g][k].numpy(), np.asarray(v),
                                       rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("kind", ["constant", "cosine", "wsd"])
def test_adam_matches_reference(kind):
    lr = {"constant": 2e-3,
          "cosine": (JO.cosine_schedule(3e-3, 2, 5),
                     TO.cosine_schedule(3e-3, 2, 5)),
          "wsd": (JO.wsd_schedule(3e-3, 1, 5), TO.wsd_schedule(3e-3, 1, 5))
          }[kind]
    lr_j, lr_t = lr if isinstance(lr, tuple) else (lr, lr)
    oj, ot = JO.Adam(lr=lr_j), TO.Adam(lr=lr_t)
    pj = jax.tree_util.tree_map(jnp.asarray, _trees(0))
    pt = _to_torch(_trees(0))
    sj, st = oj.init(pj), ot.init(pt)
    upd = jax.jit(oj.update)
    for i in range(5):
        g = _trees(10 + i)
        pj, sj = upd(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
        pt, st = ot.update(_to_torch(g), st, pt)
        _assert_trees_close(pt, pj)
        for got, want in ((st.mu, sj.mu), (st.nu, sj.nu)):
            for grp, leaves in want.items():
                for k, v in leaves.items():
                    v = np.asarray(v)
                    np.testing.assert_allclose(
                        got[grp][k].numpy(), v, rtol=1e-6,
                        atol=1e-6 * float(np.abs(v).max()), err_msg=k)
    assert int(st.count) == int(sj.count) == 5


@pytest.mark.parametrize("mk", ["cosine_schedule", "wsd_schedule"])
def test_schedule_matches_reference(mk):
    fj = jax.jit(getattr(JO, mk)(1e-3, 3, 20))
    ft = getattr(TO, mk)(1e-3, 3, 20)
    for step in range(0, 24):
        np.testing.assert_allclose(
            float(ft(torch.tensor(step, dtype=torch.int32))),
            float(fj(jnp.asarray(step, jnp.int32))), rtol=1e-6,
            err_msg=f"{mk} step {step}")


def test_global_norm_matches_reference():
    for seed in range(5):
        tree = _trees(seed)
        np.testing.assert_allclose(
            float(TO.global_norm(_to_torch(tree))),
            float(jax.jit(JO.global_norm)(tree)), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.1, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Clipped (0.1) and untouched (1e3) trees, then Adam on the clipped
    gradients: the clip the reference's ``grad_clip_norm`` applies, done
    by the caller."""
    clip_j = jax.jit(lambda t: JO.clip_by_global_norm(t, max_norm))
    for seed in range(5):
        tree = _trees(seed)
        _assert_trees_close(TO.clip_by_global_norm(_to_torch(tree), max_norm),
                            clip_j(tree))
    oj, ot = JO.Adam(lr=2e-3, grad_clip_norm=max_norm), TO.Adam(lr=2e-3)
    pj = jax.tree_util.tree_map(jnp.asarray, _trees(0))
    pt = _to_torch(_trees(0))
    sj, st = oj.init(pj), ot.init(pt)
    upd = jax.jit(oj.update)
    for i in range(5):
        g = _trees(10 + i)
        pj, sj = upd(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
        pt, st = ot.update(TO.clip_by_global_norm(_to_torch(g), max_norm),
                           st, pt)
        _assert_trees_close(pt, pj)


@pytest.mark.parametrize("config", ["kws_lstm", "ptb_lstm"])
def test_trainer_runs_on_cpu(config, capsys, tmp_path):
    path = tmp_path / "trained.npz"
    out = lstm_train.main(["--config", config, "--device", "cpu", "--steps",
                           "2", "--batch", "2", "--seq", "4",
                           "--eval-batches", "1", "--save", str(path)])
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert out["fwd_launches"] == [0, 0] and out["bwd_launches"] == [0, 0]
    assert np.isfinite(out["nll"]) and out["backend"] == "ref"
    lines = capsys.readouterr().out.splitlines()
    assert "TF32 off" in lines[0] and "device model paper" in lines[0]
    assert sum(ln.startswith("[lstm_train] step") for ln in lines) == 2
    tree = convert.load_npz(path)
    assert set(tree) == {"lstm", "fc"}


def test_trainer_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for config in ("kws_lstm", "ptb_lstm"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            lstm_train.main(["--config", config, "--steps", "1"])
