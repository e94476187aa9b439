"""Gradient accumulation: repro_torch's ``train.loop.grad_accum_step``
against the JAX package's under ``jax.jit``, at the SMOKE widths,
float32, from the same weights (``lm_params_from_jax``) and numpy-seeded
tokens and labels (6 rows of 12, three labels masked).

* qwen2.5-3b, ``n_micro`` 3 (rows of 2), train mode on ``paper``:
  microbatch ``idx`` replays the reference's ``PRNGKey(seed + idx)``
  draws through ``ReplayNoise``.  3 is where dividing by ``n_micro`` and
  multiplying by its float32 reciprocal (what jitted XLA does) part.
* moonshot-v1-16b-a3b, ``n_micro`` 2 (rows of 3), exact mode: the aux
  loss enters the gradient, not the reported loss.

The reference runs with an optimizer that hands back the gradients it is
given, so the averaged gradients are held leaf by leaf, rtol 2e-4 / atol
2e-5 (the whole-model gradient contract, and the reference's own
``test_grad_accum_equivalent_to_full_batch`` tolerance), and its loss
(rtol 1e-5) and gradient norm (rtol 2e-4 / atol 2e-5), which no
optimizer changes. The port runs so, and again with AdamW (lr 1e-3,
weight decay 0.1, clip to global norm 1.0): the same loss and gradient
norm, and every updated leaf bitwise the port's own ``Adam.update_`` of
the averaged gradients (the optimizer runs once, with their norm). The
updated leaves are not held to the reference's directly: Adam's first
step is ``lr * g / (|g| + eps)``, so a gradient near ``eps`` moves by
``lr`` with its rounding (moonshot's shared ``wo`` has one element at
3.68e-8 against the reference's 2.98e-8, inside the gradient contract,
which the update turns into 5.1e-5); the port's AdamW is held to the
reference's in ``test_torch_lm_train.py``.
A torch-only case: ``n_micro`` 1 is bitwise the port's
``make_train_step``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.train import loop as JLOOP
from repro_torch.core.crossbar import ReplayNoise
from repro_torch.launch import steps as TS
from repro_torch.train import loop as TLOOP
from repro_torch.train import optim as TO
from test_torch_lm_forward import draws, models, tbatch
from test_torch_lm_train import _at, _leaves_with_paths

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

ROWS, S = 6, 12
LOSS_RTOL, RTOL, ATOL = 1e-5, 2e-4, 2e-5
SEED = 5


def _batch(cfg):
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (ROWS, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (ROWS, S)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": toks, "labels": labels}


def _adamw(opt):
    return opt.Adam(lr=1e-3, weight_decay=0.1, grad_clip_norm=1.0)


class _JaxGrads:
    """The reference's optimizer seam, handing back the gradients."""

    def update(self, grads, state, params):
        return grads, state


class _TorchGrads:
    """The port's optimizer seam, keeping the gradients."""

    def update_(self, grads, state, params, norm=None):
        self.grads = grads
        return state


def _noise_for(tm):
    if tm.cfg.analog.mode != "train":
        return lambda seed: None
    return lambda seed: ReplayNoise(draws(tm, jax.random.PRNGKey(seed)))


def _hold_leaves(got_tree, want_tree, **tol):
    n = 0
    for keys, w in _leaves_with_paths(want_tree):
        np.testing.assert_allclose(_at(got_tree, keys).detach().numpy(), w,
                                   err_msg=str(keys), **tol)
        n += 1
    assert n == len(TO.tree_leaves(got_tree))


def _hold_metrics(got, want):
    assert set(got) == {"loss", "grad_norm"}
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch,mode,n_micro", [
    ("qwen2.5-3b", "train", 3), ("moonshot-v1-16b-a3b", "exact", 2)])
def test_grad_accum_matches_the_reference(arch, mode, n_micro):
    jm, jp, tm, tp = models(arch, mode)
    b = _batch(jm.cfg)
    micro = {k: v.reshape(n_micro, ROWS // n_micro, S) for k, v in b.items()}
    tmicro = TLOOP.split_micro(tbatch(b), n_micro)

    want_grads, _, want_m = jax.jit(JLOOP.grad_accum_step(
        jm, _JaxGrads(), n_micro))(jp, None, micro, SEED)

    def step(opt, params, state):
        return TLOOP.grad_accum_step(tm, opt, n_micro,
                                     noise_for=_noise_for(tm))(
            params, state, tmicro, SEED)

    keep = _TorchGrads()
    params = TO.tree_map(lambda p: p.detach().clone(), tp)
    _hold_metrics(step(keep, params, None)[2], want_m)
    _hold_leaves(keep.grads, want_grads, rtol=RTOL, atol=ATOL)

    # the optimizer sees neither the loss nor the gradient norm: the
    # reference's AdamW step reports want_m too
    topt = _adamw(TO)
    got_p, state, got_m = step(topt, tp, topt.init(tp))
    _hold_metrics(got_m, want_m)
    assert int(state.count) == 1
    want_p = topt.update(keep.grads, topt.init(params), params)[0]
    for a, w in zip(TO.tree_leaves(got_p), TO.tree_leaves(want_p)):
        assert torch.equal(a, w)


def test_one_microbatch_is_bitwise_the_train_step():
    """``n_micro`` 1 (qwen2.5-3b, train mode): the loss, the gradient norm
    and every updated leaf bitwise ``make_train_step``'s."""
    _, _, tm, tp = models("qwen2.5-3b", "train")
    b = tbatch(_batch(tm.cfg))
    results = []
    for make in (lambda o, nf: TS.make_train_step(tm, o, noise_for=nf),
                 lambda o, nf: TLOOP.grad_accum_step(tm, o, 1,
                                                     noise_for=nf)):
        topt = _adamw(TO)
        params = TO.tree_map(lambda p: p.detach().clone(), tp)
        batch = b if len(results) == 0 else TLOOP.split_micro(b, 1)
        p, _, m = make(topt, _noise_for(tm))(params, topt.init(params),
                                             batch, SEED)
        results.append((p, m))
    (p0, m0), (p1, m1) = results
    for k in ("loss", "grad_norm"):
        assert torch.equal(m0[k], m1[k]), k
    for a, c in zip(TO.tree_leaves(p0), TO.tree_leaves(p1)):
        assert torch.equal(a, c)
