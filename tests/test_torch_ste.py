"""The straight-through gradients of Alg. 1, primitive by primitive:
repro_torch against the JAX package under ``jax.jit`` on the same inputs
(numpy seeds), rtol and atol 1e-5.

* the NL-ADC STE (``ct * g'(x)`` on ``[x_lo, x_hi]``, inclusive) for every
  registered ramp, with one ``(P,)`` ramp and with 16-column threshold
  banks, including inputs exactly at ``x_lo`` / ``x_hi`` and outside;
* the PWM STE (``ct`` on ``[-x_max, x_max]``), including exactly +-x_max;
* ``clip_weights``: gradient 1 inside, 0 outside, exactly 0.5 at +-2.0, as
  ``jnp.clip`` differentiates;
* the LSTM tail's ``(d_gates, d_c)`` against ``jax.vjp`` of both JAX
  backends' ``lstm_gates`` (``ref``; ``pallas`` in interpret mode), hidden
  32, flat and banked (``bank_cols`` 16), random cotangents, gate values on
  thresholds and outside the ramps' domains;
* the backward kernel's wrapper: operand checks and its ctypes signature.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as JBK
from repro.core import crossbar as JCB
from repro.core import functions as JF
from repro.core import nladc as JN
from repro_torch.core import backend as TBK
from repro_torch.core import crossbar as TCB
from repro_torch.core import functions as TF
from repro_torch.core import nladc as TN
from repro_torch.kernels import lstm_cell as TLC

RTOL = ATOL = 1e-5
NAMES = sorted(TF.REGISTRY)


def _inputs(name, shape, seed):
    """Random inputs spanning past the domain, with exact hits on the
    float32 domain edges and just outside them."""
    spec = TF.get(name)
    rng = np.random.default_rng(seed)
    span = spec.x_hi - spec.x_lo
    x = rng.uniform(spec.x_lo - 0.3 * span, spec.x_hi + 0.3 * span,
                    shape).astype(np.float32)
    lo, hi = np.float32(spec.x_lo), np.float32(spec.x_hi)
    edges = np.array([lo, hi, np.nextafter(lo, np.float32(-np.inf)),
                      np.nextafter(hi, np.float32(np.inf)),
                      np.nextafter(lo, np.float32(np.inf)),
                      np.nextafter(hi, np.float32(-np.inf))], np.float32)
    x.reshape(-1)[:len(edges)] = edges
    ct = rng.normal(0, 1, shape).astype(np.float32)
    return x, ct


def _banked(ramp_j, width, tile_cols, rng):
    """The same (n_banks, P) thresholds for both packages."""
    bm_j = JN.bank_map_for(width, tile_cols)
    thr = (np.asarray(ramp_j.thresholds)[None, :]
           + rng.normal(0, 0.02, (bm_j.n_banks, 1))).astype(np.float32)
    thr.sort(axis=-1)
    return (TN.BankedThresholds(torch.from_numpy(thr),
                                TN.bank_map_for(width, tile_cols)),
            JN.BankedThresholds(jnp.asarray(thr), bm_j))


def _jax_vjp(fn, x, ct):
    def run(xx, cc):
        y, vjp = jax.vjp(fn, xx)
        return y, vjp(cc)[0]
    y, g = jax.jit(run)(jnp.asarray(x), jnp.asarray(ct))
    return np.asarray(y), np.asarray(g)


def _torch_vjp(fn, x, ct):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(ct))
    return y.detach().numpy(), g.numpy()


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_nladc_ste_matches_reference(name, banked):
    ramp_j, ramp_t = JN.build_ramp(name, 5), TN.build_ramp(name, 5)
    adc_j, adc_t = JN.NLADC(ramp_j), TN.NLADC(ramp_t)
    x, ct = _inputs(name, (6, 40), seed=len(name) + 7 * banked)
    thr_t = thr_j = None
    if banked:
        thr_t, thr_j = _banked(ramp_j, 40, 16,
                               np.random.default_rng(len(name)))
    want_y, want_g = _jax_vjp(
        lambda v: JBK.RefBackend().nladc(v, adc_j, thr_j), x, ct)
    got_y, got_g = _torch_vjp(
        lambda v: TBK.get_backend("ref").nladc(v, adc_t, thr_t), x, ct)
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_allclose(got_g, want_g, rtol=RTOL, atol=ATOL)
    spec = TF.get(name)
    inside = (x >= np.float32(spec.x_lo)) & (x <= np.float32(spec.x_hi))
    assert np.all(got_g[~inside] == 0.0)
    # the domain edges themselves pass the gradient, one step out does not
    flat = got_g.reshape(-1)
    assert np.all(flat[:2] != 0.0) and np.all(flat[2:4] == 0.0)


@pytest.mark.parametrize("name", NAMES)
def test_grad_tensor_matches_the_registry(name):
    spec = TF.get(name)
    x = np.linspace(spec.x_lo, spec.x_hi, 101)
    got = TF.grad_tensor(name, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, JF.get(name).grad(x), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("bits,x_max", [(5, 1.0), (3, 1.0), (4, 0.5)])
def test_pwm_ste_matches_reference(bits, x_max):
    rng = np.random.default_rng(bits)
    x = rng.uniform(-1.6 * x_max, 1.6 * x_max, 200).astype(np.float32)
    xm = np.float32(x_max)
    x[:4] = [xm, -xm, np.nextafter(xm, np.float32(2 * x_max)),
             np.nextafter(-xm, np.float32(-2 * x_max))]
    ct = rng.normal(0, 1, 200).astype(np.float32)
    want_y, want_g = _jax_vjp(lambda v: JN.pwm_quantize(v, bits, x_max),
                              x, ct)
    got_y, got_g = _torch_vjp(lambda v: TN.pwm_quantize(v, bits, x_max),
                              x, ct)
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_allclose(got_g, want_g, rtol=RTOL, atol=ATOL)
    assert got_g[0] == ct[0] and got_g[1] == ct[1]
    assert got_g[2] == 0.0 and got_g[3] == 0.0


def test_pwm_gradient_is_not_zero():
    """The forward rounds; without the STE autograd would give 0."""
    x = torch.linspace(-1.5, 1.5, 7, requires_grad=True)
    TN.pwm_quantize(x, 5, 1.0).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0, 1, 1, 1, 1, 1, 0])


def test_clip_weights_gradient_is_half_at_the_clip():
    w = np.array([2.0, -2.0, 3.0, 1.0, -2.5, 0.0, 1.9999999],
                 np.float32)
    want = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(JCB.clip_weights(v))))(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_(True)
    out = TCB.clip_weights(wt)
    out.sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), want)
    np.testing.assert_array_equal(wt.grad.numpy()[:4], [0.5, 0.5, 0.0, 1.0])
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.clip(w, -2.0, 2.0))


# ---------------------------------------------------------------------------
# The LSTM tail's backward
# ---------------------------------------------------------------------------

H, B = 32, 6


def _tail_inputs(seed, sig_thr, tanh_thr):
    """Gates and c with gate values exactly on thresholds (row 0) and far
    outside both domains (row 1), and random cotangents."""
    rng = np.random.default_rng(seed)
    gates = rng.normal(0, 2.0, (B, 4 * H)).astype(np.float32)
    c = rng.normal(0, 1.5, (B, H)).astype(np.float32)
    cols = np.arange(H)
    for g, thr in enumerate((sig_thr, tanh_thr, sig_thr, sig_thr)):
        p = thr.shape[-1]
        gates[0, g * H + cols] = thr[cols, cols % p] if thr.ndim == 2 \
            else thr[cols % p]
    gates[1] = rng.choice([-9.0, 9.0], 4 * H).astype(np.float32)
    ct_h = rng.normal(0, 1, (B, H)).astype(np.float32)
    ct_c = rng.normal(0, 1, (B, H)).astype(np.float32)
    return gates, c, ct_h, ct_c


def _jax_tail_vjp(backend, gates, c, ct_h, ct_c, sig, tnh, thr=None):
    be = JBK.get_backend(backend)

    def run(g, cc, ch, cc_t):
        def tail(gg, c0):
            kw = {}
            if thr is not None:
                kw = dict(sig_thr=JN.BankedThresholds(thr[0], thr[2]),
                          tanh_thr=JN.BankedThresholds(thr[1], thr[2]))
            return be.lstm_gates(gg, c0, sig, tnh, **kw)
        out, vjp = jax.vjp(tail, g, cc)
        return out, vjp((ch, cc_t))
    out, grads = jax.jit(run)(*(jnp.asarray(a) for a in
                                (gates, c, ct_h, ct_c)))
    return [np.asarray(a) for a in out], [np.asarray(a) for a in grads]


@pytest.mark.parametrize("jax_backend", ["ref", "pallas"])
@pytest.mark.parametrize("bank_cols", [0, 16])
def test_lstm_tail_gradients_match_both_jax_backends(jax_backend, bank_cols):
    ramps_j = JN.build_ramp("sigmoid", 5), JN.build_ramp("tanh", 5)
    sig_j, tnh_j = JN.NLADC(ramps_j[0]), JN.NLADC(ramps_j[1])
    sig_t = TN.NLADC(TN.build_ramp("sigmoid", 5))
    tnh_t = TN.NLADC(TN.build_ramp("tanh", 5))
    rng = np.random.default_rng(bank_cols)
    thr_j = thr_t = None
    st, tt = ramps_j[0].thresholds, ramps_j[1].thresholds
    if bank_cols:
        (bs_t, bs_j), (bt_t, bt_j) = (
            _banked(r, H, bank_cols, rng) for r in ramps_j)
        thr_j = (bs_j.thr, bt_j.thr, bs_j.bank_map)
        thr_t = (bs_t, bt_t)
        st, tt = (np.asarray(b.per_column) for b in (bs_t, bt_t))
    gates, c, ct_h, ct_c = _tail_inputs(bank_cols + 1, np.asarray(st),
                                        np.asarray(tt))
    (wh, wc), (wdg, wdc) = _jax_tail_vjp(jax_backend, gates, c, ct_h, ct_c,
                                         sig_j, tnh_j, thr_j)

    g = torch.from_numpy(gates).requires_grad_(True)
    cc = torch.from_numpy(c).requires_grad_(True)
    kw = {} if thr_t is None else dict(sig_thr=thr_t[0], tanh_thr=thr_t[1])
    n0 = TLC.lstm_gates_bwd.launches
    h, c_new = TBK.get_backend("ref").lstm_gates(g, cc, sig_t, tnh_t, **kw)
    dg, dc = torch.autograd.grad((h, c_new), (g, cc),
                                 (torch.from_numpy(ct_h),
                                  torch.from_numpy(ct_c)))
    assert TLC.lstm_gates_bwd.launches == n0          # CPU: no kernel
    np.testing.assert_allclose(h.detach().numpy(), wh, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c_new.detach().numpy(), wc, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(dg.numpy(), wdg, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dc.numpy(), wdc, rtol=RTOL, atol=ATOL)
    # row 1 lies outside every domain: no gate gradient at all
    assert np.all(dg.numpy()[1] == 0.0)


def test_bwd_wrapper_equals_its_plain_version_and_writes_codes():
    sig = TN.NLADC(TN.build_ramp("sigmoid", 5))
    tnh = TN.NLADC(TN.build_ramp("tanh", 5))
    gates, c, ct_h, ct_c = (torch.from_numpy(a) for a in _tail_inputs(
        3, sig.thresholds.numpy(), tnh.thresholds.numpy()))
    args = (gates, c, sig.thresholds, sig.y_table, tnh.thresholds,
            tnh.y_table, ct_h, ct_c)
    dom = dict(sig_domain=(TF.SIGMOID.x_lo, TF.SIGMOID.x_hi),
               tanh_domain=(TF.TANH.x_lo, TF.TANH.x_hi))
    codes = torch.zeros((5, B, H), dtype=torch.int32)
    got = TLC.lstm_gates_bwd(*args, codes=codes, **dom)
    want = TLC.lstm_gates_bwd_plain(*args, **dom)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    h, c_new = TLC.lstm_gates_plain(*args[:6])
    t = TLC.thermometer_count
    want_codes = torch.stack([
        t(gates[:, :H], sig.thresholds), t(gates[:, H:2 * H], tnh.thresholds),
        t(gates[:, 2 * H:3 * H], sig.thresholds),
        t(gates[:, 3 * H:], sig.thresholds), t(c_new, tnh.thresholds)])
    assert torch.equal(codes, want_codes.to(torch.int32))


def test_bwd_wrapper_rejects_bad_operands():
    s = TN.NLADC(TN.build_ramp("sigmoid", 5))
    t = TN.NLADC(TN.build_ramp("tanh", 5))
    g, c = torch.zeros(2, 8), torch.zeros(2, 2)
    ct = torch.zeros(2, 2)
    dom = dict(sig_domain=(-1.0, 1.0), tanh_domain=(-1.0, 1.0))
    ok = (g, c, s.thresholds, s.y_table, t.thresholds, t.y_table, ct, ct)
    TLC.lstm_gates_bwd(*ok, **dom)
    bad = [(torch.zeros(2, 8, dtype=torch.float64),) + ok[1:],
           (g, torch.zeros(2, 3)) + ok[2:],
           (g, c, torch.zeros(3, 32)) + ok[3:],
           ok[:6] + (torch.zeros(2, 3), ct),
           ok[:7] + (torch.zeros(2, 2, dtype=torch.float64),),
           ok[:6] + (torch.zeros(2, 2).t(), ct),
           (torch.zeros(8, 2).t(),) + ok[1:]]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            TLC.lstm_gates_bwd(*args, **dom)
    with pytest.raises(ValueError, match="codes"):
        TLC.lstm_gates_bwd(*ok, codes=torch.zeros((5, 2, 2)), **dom)
    with pytest.raises(ValueError, match="no kernel"):
        TLC.lstm_gates_bwd(*(a.to("meta") for a in ok), **dom)
    with pytest.raises(ValueError, match="CUDA"):
        TBK.get_backend("cuda")._lstm_tail_bwd(
            g, c, s.thresholds, t.thresholds, s, t, ct, ct)


def test_bwd_library_declares_pointer_arguments(monkeypatch):
    """Every pointer and the stream go through ctypes as ``c_void_p`` and
    the domain bounds as ``c_float``."""
    import ctypes
    from types import SimpleNamespace

    fake = SimpleNamespace(
        lstm_gates_bwd_launch=SimpleNamespace(argtypes=None, restype=None),
        cuda_error_string=SimpleNamespace(argtypes=None, restype=None))
    monkeypatch.setattr(TLC._build, "load", lambda name: fake)
    lib = TLC.bwd_library()
    fn = lib.lstm_gates_bwd_launch
    assert fn.argtypes == [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + \
        [ctypes.c_float] * 4 + [ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert lib.cuda_error_string.restype is ctypes.c_char_p
