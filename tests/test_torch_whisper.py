"""whisper-base, the encoder-decoder family: repro_torch's ``EncDecLM``
against the JAX package's at the SMOKE widths, float32, with the same
weights through ``convert.encdec_params_from_jax`` and numpy-seeded
tokens, labels and audio frames fed to both packages.

* ``CONFIG`` and ``SMOKE`` equal the reference's field for field, and
  ``n_params`` is ``tests/test_configs.py``'s pinned figure.
* ``sinusoids`` bitwise; ``layernorm_apply`` within one bfloat16 ulp
  (``LN_F32_ROW_ULPS`` in float32).
* ``forward`` and ``loss`` in exact, infer (``paper-infer``) and train
  mode (``paper``: the reference's one key, unsplit, for every layer of
  both stacks, so one ramp draw) against ``jax.jit`` of the reference's;
  ``jax.grad`` of the train-mode loss.
* ``start_decode``'s cross K/V and a run of ``decode_step`` against the
  reference's; decode against ``forward`` with the NL-ADC off.
* The kernels' semantics: the ``cuda`` backend's code on CPU tensors
  (kernel 3's gate and kernel 5's cached attention take their plain
  versions there) against the JAX ``pallas`` backend in interpret mode.
* ``launch.steps``' ``build_all``: the prefill and serve steps' greedy
  tokens equal the reference's.

Criteria: logits within LSB/2 of the gelu ramp (0.068), as the JAX
package's ``test_model_family_parity`` holds its backends; the loss within
rtol 1e-6; gradients within rtol 2e-4 / atol 2e-5 (the JAX package's
whole-model tolerance); decode against forward within rel 1e-3 (the
reference's ``test_decode_consistency``).  One model pair per mode is
built and shared.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.launch import steps as JS
from repro.nn import encdec as JE
from repro.nn import layers as JL
from repro.nn.model import build as jbuild
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core.crossbar import ReplayNoise
from repro_torch.launch import steps as TS
from repro_torch.nn import encdec as TE
from repro_torch.nn import layers as TL
from repro_torch.nn.encdec import EncDecLM
from repro_torch.nn.model import build as tbuild
from repro_torch.train import optim as TO
from test_configs import N_PARAMS_PIN
from test_torch_lm_forward import KERNELS_ON_CPU

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

ARCH = "whisper-base"
B, S = 2, 12
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
KEY = jax.random.PRNGKey(5)


@functools.lru_cache(maxsize=None)
def models(mode, *, jbk="ref", tbk="ref", enabled=True):
    """(JAX model, JAX params, port model, port params) of SMOKE in
    float32, the gelu ramp in ``mode`` (``enabled=False``: no NL-ADC)."""
    spec = dict(enabled=enabled, adc_bits=5, activation="gelu", mode=mode,
                device="paper-infer" if mode == "infer" else "paper")
    jcfg = JC.get_smoke(ARCH).replace(dtype="float32",
                                      analog=JSpec(backend=jbk, **spec))
    tcfg = TC.get_smoke(ARCH)
    tcfg = tcfg.replace(dtype="float32", analog=dataclasses.replace(
        tcfg.analog, backend=tbk, **spec))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcfg, device="cpu")
    tp = convert.encdec_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def batch(cfg, seed=0):
    """numpy tokens and labels (B, S) int32, three labels masked, and
    unit-variance frames (B, enc_len, d_model) float32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    frames = rng.normal(0, 1.0, (B, cfg.enc_len, cfg.d_model))
    return {"tokens": toks, "labels": labels,
            "frames": frames.astype(np.float32)}


def tbatch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def noise_for(tm, key=KEY):
    """The reference's train-mode draw: its forward's one key, unsplit,
    for every gate of both stacks (one threshold shape: one draw)."""
    if tm.cfg.analog.mode != "train":
        return None
    shape = tm.act._ramp_shape(tm.cfg.d_ff)
    return ReplayNoise([np.asarray(jax.random.normal(key, shape,
                                                     jnp.float32))])


def test_config_is_the_references():
    for get_j, get_t in ((JC.get, TC.get), (JC.get_smoke, TC.get_smoke)):
        want, got = get_j(ARCH), get_t(ARCH)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.padded_vocab == want.padded_vocab
    cfg = TC.get(ARCH)
    assert ARCH in TC.ARCH_NAMES
    assert (cfg.n_params(), cfg.n_active_params()) == N_PARAMS_PIN[ARCH]
    assert (cfg.vocab, cfg.padded_vocab, cfg.max_position) \
        == (51865, 52224, 32768)
    _, jp, tm, tp = models("exact")
    assert isinstance(tm, EncDecLM) and tm.device == torch.device("cpu")
    assert len(tp["enc_layers"]) == tm.cfg.n_enc_layers \
        and len(tp["dec_layers"]) == tm.cfg.n_dec_layers
    shapes_j = jax.tree_util.tree_map(lambda a: a.shape[1:],
                                      jp["dec_layers"])
    shapes_t = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                      tp["dec_layers"][0])
    assert shapes_j == shapes_t
    # the port's own init gives the reference's tree, leaf for leaf
    gen = torch.Generator()
    gen.manual_seed(0)
    own = tm.init(gen)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), own) \
        == jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)


def test_build_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbuild(cfg)
    assert isinstance(tbuild(cfg, device="cpu"), EncDecLM)


@pytest.mark.parametrize("length,channels", [(16, 64), (1500, 512),
                                             (7, 6)])
def test_sinusoids_bitwise(length, channels):
    want = JE.sinusoids(length, channels)
    got = TE.sinusoids(length, channels)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# float32: the mean and the variance sum the row in another order than
# XLA (two windows of 32 at d 64), which moves every output of a row by a
# few ulps of its largest output; measured 3 at d 64 and 4 at d 512
LN_F32_ROW_ULPS = 4


@pytest.mark.parametrize("d", [64, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype, d):
    """bfloat16 (the served dtype) within one ulp of each output; float32
    within LN_F32_ROW_ULPS ulps of the row's largest output."""
    rng = np.random.default_rng(3)
    x = rng.normal(0.3, 2.0, (16, 33, d)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, d).astype(np.float32),
         "bias": rng.normal(0, 0.1, d).astype(np.float32)}
    want = jax.jit(JL.layernorm_apply)(
        p, jnp.asarray(x).astype(getattr(jnp, dtype)))
    got = TL.layernorm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype) == f"torch.{dtype}"
    w = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got.float().numpy() - w)
    if dtype == "bfloat16":
        assert np.all(diff <= np.spacing(np.abs(w)) * 2 ** 16)
    else:
        row = np.abs(w).max(-1, keepdims=True)
        assert np.all(diff <= LN_F32_ROW_ULPS * np.spacing(row))
    init = TL.layernorm_init(d)
    assert torch.equal(init["scale"], torch.ones(d)) \
        and torch.equal(init["bias"], torch.zeros(d))


def _check(jm, jp, tm, tp):
    b = batch(jm.cfg)
    (jl, jmet), jlog = jax.jit(lambda p, bb, k: (
        jm.loss(p, bb, key=k),
        jm.forward(p, bb["tokens"], {"frames": bb["frames"]}, key=k)))(
            jp, b, KEY)
    tb = tbatch(b)
    noise = noise_for(tm)
    tl, tmet = tm.loss(tp, tb, noise=noise)
    assert noise is None or noise.remaining == 0
    tlog = tm.forward(tp, tb["tokens"], {"frames": tb["frames"]},
                      noise=noise_for(tm))
    assert tlog.shape == (B, S, tm.cfg.padded_vocab)
    assert tlog.dtype == torch.float32 and torch.isfinite(tlog).all()
    diff = float(np.max(np.abs(np.asarray(jlog) - tlog.detach().numpy())))
    assert diff < jm.act.ramp.lsb / 2, diff
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=LOSS_RTOL)
    assert set(tmet) == set(jmet) == {"loss", "tokens"}
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == B * S - 3
    return diff


@pytest.mark.parametrize("mode", ["exact", "infer", "train"])
def test_forward_and_loss_match_jax(mode):
    _check(*models(mode))


def test_train_mode_draws_once_for_both_stacks():
    """Every gate of the 2 + 2 layers reads the one draw: a source with a
    second draw is left holding it, and other draws move the logits."""
    jm, _, tm, tp = models("train")
    tb = tbatch(batch(jm.cfg))
    shape = tm.act._ramp_shape(tm.cfg.d_ff)
    noise = ReplayNoise([np.zeros(shape, np.float32)] * 2)
    flat = tm.forward(tp, tb["tokens"], {"frames": tb["frames"]},
                      noise=noise)
    assert noise.remaining == 1
    moved = tm.forward(tp, tb["tokens"], {"frames": tb["frames"]},
                       noise=noise_for(tm))
    assert not torch.equal(flat, moved)


def test_grads_match_jax():
    """``jax.grad`` of the reference's train-mode loss (its one key): every
    leaf, ``enc_layers`` and ``dec_layers`` split per layer."""
    jm, jp, tm, tp = models("train")
    b = batch(jm.cfg, seed=1)
    want = jax.jit(jax.grad(lambda p: jm.loss(p, b, key=KEY)[0]))(jp)
    leaves = TO.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        total, _ = tm.loss(tp, tbatch(b), noise=noise_for(tm), remat=True)
        grads = torch.autograd.grad(total, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    got = {id(p): g for p, g in zip(leaves, grads)}
    n = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        keys = [k.key for k in path]
        w = np.asarray(w)
        per_layer = keys[0] in ("enc_layers", "dec_layers")
        for i in range(w.shape[0]) if per_layer else [None]:
            node = tp[keys[0]][i] if per_layer else tp[keys[0]]
            for k in keys[1:]:
                node = node[k]
            np.testing.assert_allclose(
                got[id(node)].numpy(), w[i] if per_layer else w,
                rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=str((keys, i)))
            n += 1
    assert n == len(leaves)
    gate = got[id(tp["enc_layers"][0]["mlp"]["wi"]["w"])]
    assert float(gate.abs().max()) > 0


def _decode_run(jm, jp, tm, tp, steps=6):
    """``start_decode`` on the same frames, then ``steps`` decode steps of
    numpy tokens on both packages: the cross K/V's and the logits' largest
    differences."""
    cfg = jm.cfg
    b = batch(cfg, seed=2)
    toks = b["tokens"][:, :steps]
    jstate = jax.jit(jm.start_decode)(jp, jm.init_decode_state(B, 16),
                                      jnp.asarray(b["frames"]))
    tstate = tm.start_decode(tp, tm.init_decode_state(B, 16),
                             torch.from_numpy(b["frames"]))
    cross = max(float(np.max(np.abs(
        np.asarray(jstate[f"cross_{n}"])[i]
        - tstate["cross"][i][n].numpy())))
        for i in range(cfg.n_dec_layers) for n in "kv")
    jstep = jax.jit(jm.decode_step)
    worst = 0.0
    for t in range(steps):
        jl, jstate = jstep(jp, jstate, jnp.asarray(toks[:, t:t + 1]))
        tl, tstate = tm.decode_step(tp, tstate,
                                    torch.from_numpy(toks[:, t:t + 1]).long())
        worst = max(worst, float(np.max(np.abs(np.asarray(jl)
                                               - tl.numpy()))))
    assert tstate["index"] == int(jstate["index"]) == steps
    return cross, worst


@pytest.mark.parametrize("mode", ["exact", "infer"])
def test_start_decode_and_decode_steps_match_jax(mode):
    jm, jp, tm, tp = models(mode)
    cross, worst = _decode_run(jm, jp, tm, tp)
    assert cross < 1e-5, cross
    assert worst < jm.act.ramp.lsb / 2, worst


def test_decode_matches_forward_without_the_nladc():
    """The reference's ``test_decode_consistency`` on the port: NL-ADC
    off, ``start_decode`` then teacher-forced decode steps against
    ``forward``, rel < 1e-3; the state's cross K/V are read, not
    written."""
    _, _, tm, tp = models("exact", enabled=False)
    b = tbatch(batch(tm.cfg, seed=4))
    full = tm.forward(tp, b["tokens"], {"frames": b["frames"]})
    state = tm.start_decode(tp, tm.init_decode_state(B, 32), b["frames"])
    cross = [c["k"].clone() for c in state["cross"]]
    outs = []
    for t in range(S):
        logits, state = tm.decode_step(tp, state, b["tokens"][:, t:t + 1])
        outs.append(logits[:, 0])
    rel = float((torch.stack(outs, 1) - full).abs().max()
                / full.abs().max())
    assert rel < 1e-3, rel
    assert all(torch.equal(a, c["k"]) for a, c in zip(cross,
                                                      state["cross"]))


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_kernel_semantics_match_jax_pallas(mode):
    """The cuda backend's code (the gate's autograd Function and kernel
    3's plain version; kernel 5's at decode) against the JAX ``pallas``
    backend in interpret mode (the reference's decode attention takes
    ``ref``: it passes no backend)."""
    jm, jp, tm, tp = models(mode, jbk="pallas", tbk=KERNELS_ON_CPU)
    for p in TO.tree_leaves(tp):
        p.requires_grad_(True)             # through the Functions
    try:
        _check(jm, jp, tm, tp)
    finally:
        for p in TO.tree_leaves(tp):
            p.requires_grad_(False)
    if mode == "infer":
        _, worst = _decode_run(jm, jp, tm, tp, steps=3)
        assert worst < jm.act.ramp.lsb / 2, worst


def test_build_all_steps_match_jax():
    """``build_all``'s prefill and serve steps: the greedy tokens of the
    prompt and of two decode steps after ``start_decode`` are the
    reference's."""
    jm, jp, tm, tp = models("exact")
    _, _, jprefill, jserve = JS.build_all(jm.cfg)
    model, train_step, prefill, serve = TS.build_all(tm.cfg, "cpu")
    assert isinstance(model, EncDecLM) and callable(train_step)
    b = batch(jm.cfg, seed=5)
    jtok, jlog = jax.jit(jprefill)(jp, {"tokens": b["tokens"],
                                        "frames": b["frames"]})
    ttok, tlog = prefill(tp, {"tokens": tbatch(b)["tokens"],
                              "frames": torch.from_numpy(b["frames"])})
    assert ttok.dtype == torch.int32 and tuple(ttok.shape) == (B, 1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    jstate = jm.start_decode(jp, jm.init_decode_state(B, 16),
                             jnp.asarray(b["frames"]))
    tstate = model.start_decode(tp, model.init_decode_state(B, 16),
                                torch.from_numpy(b["frames"]))
    jt, tt = jnp.asarray(b["tokens"][:, :1]), tbatch(b)["tokens"][:, :1]
    for _ in range(2):
        jt, jstate = jax.jit(jserve)(jp, jstate, jt)
        tt, tstate = serve(tp, tstate, tt)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, tt = jt[:, None], tt[:, None].long()
    assert tstate["index"] == 2
