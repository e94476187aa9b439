"""LM training: repro_torch's gradients, optimizer and trainer against the
JAX package's, at the SMOKE widths of qwen2.5-3b and moonshot-v1-16b-a3b,
float32, train mode on the ``paper`` preset (ramp-step noise replayed from
the reference's per-layer keys, as in ``tests/test_torch_lm_forward.py``).

* Whole-model gradients of ``LM.loss`` against ``jax.grad`` of the
  reference's, rtol 2e-4 / atol 2e-5 (the JAX package's own whole-model
  tolerance, ``tests/test_backend_parity.py::test_model_train_grad_parity``),
  with ``remat`` on and off; the port's remat changes no bit.
* The backward of each ``cuda``-backend Function (the NL-ADC, the fused
  gate with and without a bias, the expert gate, the cached attention),
  run with its kernel's plain version on the CPU, against ``jax.vjp`` of
  the JAX ``pallas`` backend's ``custom_vjp`` (interpret mode), rtol and
  atol 1e-5; and each carries a gradient upstream (non-zero).
* ``Adam`` with weight decay 0.1 and a clip to global norm 1.0 against
  the jitted reference: moments bitwise where the clip does not act, the
  params within 2 ulps; where it acts, the global norm sums in another
  order (XLA's is further from float64 than torch's), so the scale
  differs by an ulp, and everything is held to rtol 1e-6 / atol 1e-6 of
  the leaf's largest magnitude.
  ``update_`` (in place, chunked) is bitwise ``update``.
* Three ``Trainer`` steps of ``make_train_step`` against the JAX
  ``Trainer`` over ``make_train_step``: losses within rtol 1e-5.
* ``python -m repro_torch.launch.train --smoke --device cpu --steps 2``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as JBK
from repro.core import nladc as JN
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import steps as JS
from repro.train import loop as JLOOP
from repro.train import optim as JO
from repro_torch.core import backend as TBK
from repro_torch.core import nladc as TN
from repro_torch.core.crossbar import ReplayNoise
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import fused_matmul_nladc as TFM
from repro_torch.launch import kernel_tune as TKT
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TTRAIN
from repro_torch.train import loop as TLOOP
from repro_torch.train import optim as TO
from test_torch_lm_forward import batch, draws, models, noise_for, tbatch

ROOT = Path(__file__).resolve().parents[1]
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
FN_TOL = 1e-5
ARCHS = ("qwen2.5-3b", "moonshot-v1-16b-a3b")


def _leaves_with_paths(jtree):
    """(path, JAX leaf) pairs; ``layers`` leaves split per layer, as the
    port keeps them."""
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        keys = [k.key for k in path]
        if keys[0] == "layers":
            out += [(["layers", i] + keys[1:], np.asarray(leaf)[i])
                    for i in range(leaf.shape[0])]
        else:
            out.append((keys, np.asarray(leaf)))
    return out


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _torch_grads(tm, tp, b, key, remat):
    leaves = TO.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    total, _ = tm.loss(tp, tbatch(b), noise=noise_for(tm, key), remat=remat)
    grads = torch.autograd.grad(total, leaves)
    by_leaf = {id(p): g for p, g in zip(leaves, grads)}
    return TO.tree_map(lambda p: by_leaf[id(p)], tp)


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_grads_match_jax(arch, banked):
    bank_cols = {"qwen2.5-3b": 64, "moonshot-v1-16b-a3b": 16}[arch] \
        if banked else 0
    jm, jp, tm, tp = models(arch, "train", bank_cols)
    b, key = batch(jm.cfg, seed=1), jax.random.PRNGKey(3)
    want = jax.jit(jax.grad(lambda p: jm.loss(p, b, key=key,
                                              remat=True)[0]))(jp)
    got = _torch_grads(tm, tp, b, key, remat=True)
    plain = _torch_grads(tm, tp, b, key, remat=False)
    n = 0
    for keys, w in _leaves_with_paths(want):
        g = _at(got, keys)
        assert torch.equal(g, _at(plain, keys)), keys    # remat: same bits
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=str(keys))
        n += 1
    assert n == len(TO.tree_leaves(tp))
    # the gradient reaches the gates behind the NL-ADC
    layer = got["layers"][0]
    gate = layer["mlp"]["wi_gate"]["w"] if "mlp" in layer \
        else layer["moe"]["w_gate"]
    assert float(gate.abs().max()) > 0


def test_remat_dots_is_not_ported():
    _, _, tm, tp = models("qwen2.5-3b", "exact")
    tm.cfg = tm.cfg.replace(remat_policy="dots")
    b = tbatch(batch(tm.cfg))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.loss(tp, b, remat=True)
    tm.loss(tp, b, remat=False)                  # no recompute, no raise


# -- the cuda backend's Functions, their kernels' plain versions ------------

def _ramps(name="silu"):
    return JN.NLADC(JN.build_ramp(name, 5)), TN.NLADC(TN.build_ramp(name, 5))


def _vjp_pair(jfn, tfn, args, ct):
    def run(a, c):
        y, vjp = jax.vjp(jfn, *a)
        return y, vjp(c)
    wy, wg = jax.jit(run)([jnp.asarray(a) for a in args], jnp.asarray(ct))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = tfn(*targs)
    assert y.grad_fn is not None
    gg = torch.autograd.grad(y, targs, torch.from_numpy(ct))
    return (np.asarray(wy), [np.asarray(g) for g in wg],
            y.detach().numpy(), [g.numpy() for g in gg])


def _hold(want_y, want_g, got_y, got_g, y_atol=0.0):
    np.testing.assert_allclose(got_y, want_y, rtol=0, atol=y_atol)
    for w, g in zip(want_g, got_g):
        np.testing.assert_allclose(g, w, rtol=FN_TOL, atol=FN_TOL)
        assert np.abs(g).max() > 0


def test_nladc_function_backward_matches_pallas():
    adc_j, adc_t = _ramps("sigmoid")
    rng = np.random.default_rng(0)
    x = rng.normal(0, 4, (24, 64)).astype(np.float32)
    ct = rng.normal(0, 1, x.shape).astype(np.float32)
    res = _vjp_pair(lambda v: JBK.get_backend("pallas").nladc(v, adc_j),
                    lambda v: TBK.CudaBackend("cpu").nladc(v, adc_t), [x], ct)
    # the Pallas kernel decodes in closed form, the port by the table
    _hold(*res, y_atol=1e-6)


@pytest.mark.parametrize("bias", [False, True])
def test_gate_function_backward_matches_pallas(bias):
    adc_j, adc_t = _ramps()
    rng = np.random.default_rng(1 + bias)
    x = rng.normal(0, 1, (3, 5, 48)).astype(np.float32)
    w = rng.normal(0, 0.3, (48, 40)).astype(np.float32)
    b = rng.normal(0, 0.5, (40,)).astype(np.float32)
    ct = rng.normal(0, 1, (3, 5, 40)).astype(np.float32)
    args = [x, w, b] if bias else [x, w]

    def jfn(xx, ww, bb=None):
        return JBK.get_backend("pallas").matmul_nladc(xx, ww, adc_j, bias=bb)

    def tfn(xx, ww, bb=None):
        return TBK.CudaBackend("cpu").matmul_nladc(xx, ww, adc_t, bias=bb)

    n0 = TFM.fused_matmul_nladc.launches
    # the kernel's f32 accumulator flips no code here: outputs equal
    _hold(*_vjp_pair(jfn, tfn, args, ct), y_atol=1e-6)
    assert TFM.fused_matmul_nladc.launches == n0        # CPU: no kernel


def test_expert_gate_function_backward_matches_pallas():
    adc_j, adc_t = _ramps()
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4, 6, 32)).astype(np.float32)
    x[1, -2:] = 0.0                              # empty capacity rows
    w = rng.normal(0, 0.3, (4, 32, 24)).astype(np.float32)
    ct = rng.normal(0, 1, (4, 6, 24)).astype(np.float32)
    _hold(*_vjp_pair(
        lambda a, b: JBK.get_backend("pallas").moe_matmul_nladc(a, b, adc_j),
        lambda a, b: TBK.CudaBackend("cpu").moe_matmul_nladc(a, b, adc_t),
        [x, w], ct), y_atol=1e-6)


def test_attention_function_backward_matches_pallas():
    rng = np.random.default_rng(4)
    q = rng.normal(0, 1, (3, 1, 4, 16)).astype(np.float32)
    k = rng.normal(0, 1, (3, 10, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (3, 10, 2, 16)).astype(np.float32)
    ct = rng.normal(0, 1, q.shape).astype(np.float32)
    mask = np.arange(10)[None, None, :] < np.array([10, 1, 6])[:, None, None]
    res = _vjp_pair(
        lambda a, b, c: JBK.get_backend("pallas").prefill_attention(
            a, b, c, jnp.asarray(mask)),
        lambda a, b, c: TBK.CudaBackend("cpu").prefill_attention(
            a, b, c, torch.from_numpy(mask)), [q, k, v], ct)
    np.testing.assert_allclose(res[2], res[0], rtol=0, atol=1e-6)
    for w, g in zip(res[1], res[3]):
        np.testing.assert_allclose(g, w, rtol=FN_TOL, atol=FN_TOL)


def test_functions_only_under_grad():
    """Without a gradient the backend launches the kernel alone: the
    output carries no graph."""
    _, adc_t = _ramps()
    x = torch.randn(4, 8)
    w = torch.randn(8, 12)
    assert TBK.CudaBackend("cpu").matmul_nladc(x, w, adc_t).grad_fn is None
    assert TBK.CudaBackend("cpu").matmul_nladc(
        x, w.requires_grad_(True), adc_t).grad_fn is not None
    with torch.no_grad():
        assert TBK.CudaBackend("cpu").matmul_nladc(x, w, adc_t).grad_fn is None
    with pytest.raises(ValueError, match="CUDA tensors"):
        TBK.get_backend("cuda").matmul_nladc(x, w, adc_t)


def test_kernel_tune_grad_halves_match_the_jax_sweep():
    """``launch.kernel_tune``'s gradient halves at the JAX sweep's own
    inputs (``benchmarks/kernel_tune.py::_parity_section``, seed 7, its
    draw order replayed): finite and equal to the sweep's values within
    1e-6."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_kernel_tune", ROOT / "benchmarks" / "kernel_tune.py")
    jkt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jkt)
    want = jkt._parity_section(np.random.default_rng(7))

    rng = np.random.default_rng(7)
    ramp = TN.build_ramp("swish", 5)
    adc = TN.NLADC(ramp)
    n = 256
    bm = TN.bank_map_for(n, jkt.BANK_COLS)
    thr = np.sort(rng.normal(0, 1, (bm.n_banks, len(ramp.thresholds))),
                  axis=1).astype(np.float32)
    bt = TN.BankedThresholds(torch.from_numpy(thr), bm)

    def draw(*shape, scale):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(
            np.float32))

    draw(32, n, scale=1.5), draw(64, n, scale=0.3), draw(16, 64, scale=0.5)
    xe, we = draw(4, 8, 64, scale=0.5), draw(4, 64, n, scale=0.3)
    q, kc, vc = draw(3, 1, 8, 16, scale=1), draw(3, 24, 2, 16, scale=1), \
        draw(3, 24, 2, 16, scale=1)
    mask = (torch.arange(24) < 17)[None, None, :]
    got = {"moe_einsum": TKT.expert_gate_grad_err(xe, we, adc, bt),
           "attention": TKT.attention_grad_err(q, kc, vc, mask)}
    for k, v in got.items():
        assert np.isfinite(v)
        assert abs(v - want[k]["grad_max_err"]) <= 1e-6, (k, v, want[k])


# -- Adam ----------------------------------------------------------------

def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (scale * rng.standard_normal((40, 30))).astype(
        np.float32)}, "b": (scale * rng.standard_normal(77)).astype(
            np.float32)}


def _ulps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got.astype(np.float64) - want)
                        / np.spacing(np.abs(want))))


@pytest.mark.parametrize("grad_scale", [0.001, 1.0])
def test_adamw_with_clip_matches_reference(grad_scale):
    """Scale 0.001 leaves the global norm under 1: no clip, the moments
    bitwise, the params within 2 ulps.  Scale 1.0 clips every step: the
    scale differs by an ulp (the norm's summation order), and a moment
    whose two terms nearly cancel moves by many ulps of itself, so the
    tolerance is the one the LSTM's Adam test uses, rtol 1e-6 and atol
    1e-6 of the leaf's largest magnitude."""
    lr_j = JO.cosine_schedule(3e-4, 2, 10)
    lr_t = TO.cosine_schedule(3e-4, 2, 10)
    oj = JO.Adam(lr=lr_j, weight_decay=0.1, grad_clip_norm=1.0)
    ot = TO.Adam(lr=lr_t, weight_decay=0.1, grad_clip_norm=1.0)
    pj = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    pt = TO.tree_map(torch.from_numpy, _tree(0))
    sj, st = oj.init(pj), ot.init(pt)
    upd = jax.jit(oj.update)
    for i in range(4):
        g = _tree(10 + i, grad_scale)
        pj, sj = upd(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
        pt, st = ot.update(TO.tree_map(torch.from_numpy, g), st, pt)
        for got, want, name in ((pt, pj, "params"), (st.mu, sj.mu, "mu"),
                                (st.nu, sj.nu, "nu")):
            for a, w in zip(TO.tree_leaves(got),
                            jax.tree_util.tree_leaves(want)):
                a, w = a.numpy(), np.asarray(w)
                if grad_scale >= 1:
                    np.testing.assert_allclose(
                        a, w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                        err_msg=name)
                elif name == "params":
                    assert _ulps(a, w) <= 2
                else:
                    np.testing.assert_array_equal(a, w, err_msg=name)


@pytest.mark.parametrize("given_norm", [False, True])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_in_place_update_is_bitwise_the_functional_one(clip, given_norm):
    """``update_`` is bitwise ``update``, also when the caller hands it the
    gradients' global norm (as the train step does)."""
    opt = TO.Adam(lr=TO.cosine_schedule(3e-4, 2, 10), weight_decay=0.1,
                  grad_clip_norm=clip)
    params = TO.tree_map(torch.from_numpy, _tree(0))
    params = {**params, "layers": [TO.tree_map(torch.from_numpy, _tree(5))]}
    state = opt.init(params)
    inplace = TO.tree_map(torch.clone, params)
    st_in = opt.init(inplace)
    for i in range(3):
        g = {**TO.tree_map(torch.from_numpy, _tree(10 + i)),
             "layers": [TO.tree_map(torch.from_numpy, _tree(20 + i))]}
        params, state = opt.update(g, state, params)
        norm = TO.global_norm(g) if given_norm else None
        st_in = opt.update_(g, st_in, inplace, chunk=16,     # ragged chunks
                            norm=norm)
        for tree_a, tree_b in ((params, inplace), (state.mu, st_in.mu),
                               (state.nu, st_in.nu)):
            for a, b in zip(TO.tree_leaves(tree_a), TO.tree_leaves(tree_b)):
                assert torch.equal(a, b)
    assert int(st_in.count) == int(state.count) == 3


# -- the trainer -----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_three_trainer_steps_match_the_reference(arch):
    jm, jp, tm, tp = models(arch, "train")
    seq, bsz, steps = 10, 2, 3
    jopt = JS.make_optimizer(jm.cfg, total_steps=steps)
    jtr = JLOOP.Trainer(jm, jopt, JS.make_train_step(jm, jopt),
                        JSyntheticLM(jm.cfg.vocab, seq, bsz), log_every=1)
    jtr.fit(JLOOP.TrainState(jp, jopt.init(jp)), steps)

    topt = TS.make_optimizer(tm.cfg, total_steps=steps)
    step = TS.make_train_step(tm, topt, noise_for=lambda seed: ReplayNoise(
        draws(tm, jax.random.PRNGKey(seed))))
    ttr = TLOOP.Trainer(tm, topt, step, SyntheticLM(tm.cfg.vocab, seq, bsz),
                        put_batch=lambda b: TLOOP.to_device_batch(
                            b, torch.device("cpu")), log=None)
    state = ttr.fit(TLOOP.TrainState(tp, topt.init(tp)), steps)
    assert [h["step"] for h in ttr.history] == [1, 2, 3]
    assert len(ttr.step_ms) == steps and int(state.opt_state.count) == 3
    for got, want in zip(ttr.history, jtr.history):
        for k in ("loss", "aux_loss", "tokens", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert ttr.history[0]["tokens"] == seq * bsz


def test_trainer_refuses_checkpoints():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TLOOP.Trainer(None, None, None, None, ckpt_dir="ckpt")


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_smoke_on_cpu(arch, capsys):
    out = TTRAIN.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--analog-mode", "train", "--analog-device",
                       "paper"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "TF32 off" in lines[0] and "backend ref" in lines[0]
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"] + out["grad_norms"]))
    assert out["launches"] == [{k: 0 for k in TTRAIN.KERNELS}] * 2
    assert (out["aux_losses"][0] > 0) == (arch != "qwen2.5-3b")


@pytest.mark.parametrize("flag", [["--ckpt-dir", "x"], ["--production-mesh"],
                                  ["--grad-comm", "int8"]])
def test_launcher_refuses_unported_options(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TTRAIN.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                     "--steps", "1"] + flag)
