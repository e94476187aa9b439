"""Training the recurrent LM families: repro_torch's train-mode ``LM``,
train step and ``Trainer`` for mamba2-370m (``ssm``: 2 SSD layers) and
recurrentgemma-9b (``hybrid`` at ``n_layers=5``: one (rec, rec, attn)
group and a (rec, rec) tail) against the JAX package's, at the SMOKE
widths, float32, the ``paper`` preset's ramp-step noise, flat thresholds
and 16-column banks, the same weights through ``lm_params_from_jax``.
B 2 x S 20: mamba2's SSD crosses two 16-step chunks, the second padded
with ``dt = 0`` steps, and recurrentgemma's window 8 binds.

* The reference's key tree, replayed (:func:`draws`): ``split(k)`` once a
  layer (ssm) or a group (hybrid), whose NL-ADCs all take that key, and
  the forward's own key, unsplit, for every block of the hybrid's tail.
  A draw is ``normal(key, shape)`` whichever activation makes it, so a
  key draws one tensor per distinct threshold shape across activations
  (flat: one per key).  The port's forward takes exactly these draws, and
  a wrong tree moves its logits.
* Train-mode logits against ``jm.forward(key=)`` within LSB/2 of the
  hidden ramp (silu 0.102, gelu 0.068; measured below 2e-6), the loss
  within ``LOSS_RTOL``.
* Gradients of ``LM.loss`` against ``jax.grad`` of the reference's, rtol
  2e-4 / atol 2e-5 (``test_model_train_grad_parity``'s): torch autograd
  through the SSD chunk loop and the RG-LRU sequential scan against the
  reference's autodiff of its associative scans.  ``remat=True`` (a
  layer or a group recomputed, the tail not) is bitwise ``remat=False``.
* The kernels' semantics: the ``cuda`` backend's code on the CPU (its
  autograd Functions, the kernel wrappers' plain versions) against the
  JAX ``pallas`` backend in interpret mode, forward and gradients.

The trainer and the launcher on these models are held in
``tests/test_torch_lm_recurrent_trainer.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.crossbar import ReplayNoise
from repro_torch.train import optim as TO
from test_torch_lm_recurrent import KERNELS_ON_CPU, models

ARCHS = ("mamba2-370m", "recurrentgemma-9b")
OVERRIDES = {"mamba2-370m": (), "recurrentgemma-9b": (("n_layers", 5),)}
BANK_COLS = 16
B, S = 2, 20
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
KEY = jax.random.PRNGKey(5)


def _models(arch, bank_cols=0, jbk="ref", tbk="ref"):
    """The JAX and port models in train mode on ``paper``; the port's
    params cloned, so a test's in-place update or ``requires_grad`` does
    not reach the shared ones."""
    jm, jp, tm, tp = models(arch, "train", bank_cols, jbk, tbk,
                            OVERRIDES[arch])
    return jm, jp, tm, TO.tree_map(torch.clone, tp)


def _shape(act, width):
    """The reference activation's threshold shape at ``width``."""
    bank = act.bank_for(width)
    return tuple((bank.thr if bank is not None else act.adc.thresholds)
                 .shape)


def _calls(jm, kind):
    """The reference's NL-ADC calls of a block that take its key, in
    order: (JAX activation, width)."""
    cfg = jm.cfg
    if kind == "ssd":
        d_inner = cfg.ssm_expand * cfg.d_model
        return [(jm.softplus_act, d_inner // cfg.ssm_headdim),
                (jm.silu_act, d_inner)]
    if kind == "rec":                  # r and i gates, W_g, the MLP gate
        return [(jm.sigmoid_act, cfg.lru_width)] * 2 + [
            (jm.act, cfg.lru_width), (jm.act, cfg.d_ff)]
    return [(jm.act, cfg.d_ff)]


def key_units(jm):
    """The reference's keyed units: ``(split, kinds)`` per layer or group
    in scan order (``split``: the unit takes ``split(k)``'s second key),
    then the hybrid's tail, which takes the forward's key as it is."""
    cfg, kinds = jm.cfg, jm.layer_kinds()
    if cfg.family != "hybrid":
        return [(True, (kind,)) for kind in kinds]
    n = len(cfg.block_pattern)
    n_scanned = cfg.n_layers // n * n
    units = [(True, kinds[i:i + n]) for i in range(0, n_scanned, n)]
    return units + ([(False, kinds[n_scanned:])] if kinds[n_scanned:]
                    else [])


def draws(jm, key, units=None):
    """The reference's train-mode ramp draws in the order the port takes
    them: per unit, ``normal(unit_key, shape)`` for each distinct
    threshold shape of its calls, in the order of first use."""
    out, k = [], key
    for split, kinds in units or key_units(jm):
        if split:
            k, k_unit = jax.random.split(k)
        else:
            k_unit = key
        shapes = []
        for kind in kinds:
            for act, width in _calls(jm, kind):
                shape = _shape(act, width)
                if shape not in shapes:
                    shapes.append(shape)
                    out.append(np.asarray(jax.random.normal(
                        k_unit, shape, jnp.float32)))
    return out


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": toks, "labels": labels}


def _tbatch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


_JITTED = {}


def _jax_forward(jm, jp, b):
    """The reference's train-mode (logits, loss) and gradient at ``KEY``,
    jitted once per model."""
    if id(jm) not in _JITTED:
        _JITTED[id(jm)] = jax.jit(lambda p, bb, k: (
            jm.forward(p, bb["tokens"], key=k),
            jm.loss(p, bb, key=k, remat=True)[0],
            jax.grad(lambda q: jm.loss(q, bb, key=k, remat=True)[0])(p)))
    logits, loss, grads = _JITTED[id(jm)](jp, b, KEY)
    return np.asarray(logits), float(loss), grads


def _torch_grads(tm, tp, b, remat, replay):
    leaves = TO.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    total, _ = tm.loss(tp, _tbatch(b), noise=ReplayNoise(replay),
                       remat=remat)
    grads = torch.autograd.grad(total, leaves)
    by_leaf = {id(p): g for p, g in zip(leaves, grads)}
    return float(total.detach()), TO.tree_map(lambda p: by_leaf[id(p)], tp)


def _leaves_with_paths(jtree):
    """(path, JAX leaf) pairs; the stacked ``layers`` and ``groups`` split
    along their leading axis, as the port keeps them."""
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] in ("layers", "groups"):
            out += [([keys[0], i] + keys[1:], np.asarray(leaf)[i])
                    for i in range(leaf.shape[0])]
        else:
            out.append((keys, np.asarray(leaf)))
    return out


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _hold_grads(want, got, plain=None):
    n = 0
    for keys, w in _leaves_with_paths(want):
        g = _at(got, keys)
        if plain is not None:
            assert torch.equal(g, _at(plain, keys)), keys   # remat: same bits
        assert torch.isfinite(g).all(), keys
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=str(keys))
        n += 1
    assert n == len(TO.tree_leaves(got))


def _logits(tm, tp, toks, replay):
    """The port's train-mode logits on ``replay``'s draws, every one of
    them taken."""
    noise = ReplayNoise(replay)
    with torch.no_grad():
        got = tm.forward(tp, torch.from_numpy(toks).long(), noise=noise)
    assert noise.remaining == 0
    return got.numpy()


# the draws each key gives: (flat, banked) counts per arch
N_DRAWS = {"mamba2-370m": (2, 4),          # 2 layers: (P,) / (P,), (8, P)
           "recurrentgemma-9b": (2, 4)}    # group + tail: (P,) / (4, P),
#                                            (8, P) each


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_draws_replay_the_key_tree(arch, banked):
    """The port takes the reference's draws, one per distinct shape across
    activations a key; the logits agree only with that tree: the hybrid's
    tail on a split key, or the SSD layers on an unsplit one, moves
    them."""
    jm, jp, tm, tp = _models(arch, BANK_COLS if banked else 0)
    b = _batch(jm.cfg)
    want, _, _ = _jax_forward(jm, jp, b)
    replay = draws(jm, KEY)
    assert len(replay) == N_DRAWS[arch][banked]
    if jm.cfg.family == "hybrid":
        assert len(tp["groups"]) == 1 and len(tp["tail"]) == 2
        # the tail's draws come from the forward's key, unsplit
        np.testing.assert_array_equal(replay[-1], np.asarray(
            jax.random.normal(KEY, replay[-1].shape, jnp.float32)))
    got = _logits(tm, tp, b["tokens"], replay)
    assert np.abs(got - want).max() < 1e-4
    # a wrong tree: the hybrid's tail on the split chain, or every SSD
    # layer on the forward's own key
    hybrid = jm.cfg.family == "hybrid"
    wrong = [(hybrid, kinds) for _, kinds in key_units(jm)]
    bad = _logits(tm, tp, b["tokens"], draws(jm, KEY, wrong))
    assert np.abs(bad - want).max() > 1e-3


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_and_grads_match_jax(arch, banked):
    jm, jp, tm, tp = _models(arch, BANK_COLS if banked else 0)
    b = _batch(jm.cfg)
    want_logits, want_loss, want = _jax_forward(jm, jp, b)
    got = _logits(tm, tp, b["tokens"], draws(jm, KEY))
    assert np.abs(got - want_logits).max() < jm.act.ramp.lsb / 2
    loss, grads = _torch_grads(tm, tp, b, True, draws(jm, KEY))
    loss_plain, plain = _torch_grads(tm, tp, b, False, draws(jm, KEY))
    assert loss == loss_plain
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    _hold_grads(want, grads, plain)
    # the gradient reaches the gates behind the NL-ADCs
    blk = tm.blocks(grads)[0][1]
    gate = blk["ssd"]["in_proj"]["w"] if "ssd" in blk else blk["rec"]["wa"]
    assert float(gate.abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_semantics_match_jax_pallas(arch):
    """``cuda``'s code on the CPU against JAX ``pallas`` (interpret mode),
    train mode, banked: logits and gradients."""
    jm, jp, tm, tp = _models(arch, BANK_COLS, jbk="pallas",
                             tbk=KERNELS_ON_CPU)
    b = _batch(jm.cfg)
    want_logits, want_loss, want = _jax_forward(jm, jp, b)
    got = _logits(tm, tp, b["tokens"], draws(jm, KEY))
    assert np.abs(got - want_logits).max() < jm.act.ramp.lsb / 2
    loss, grads = _torch_grads(tm, tp, b, True, draws(jm, KEY))
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    _hold_grads(want, grads)
