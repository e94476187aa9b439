"""The fused LSTM tail: the port's plain version against the JAX package.

The rounding contract: ``c' = fma(f, c, i*a)`` rounded once, and
``h' = o * t``.  XLA on the CPU contracts the reference's ``f*c + i*a``
into exactly that fused multiply-add under ``jax.jit``, so the port's
plain version must equal ``jax.jit(RefBackend().lstm_gates)`` bitwise on
h' and c' (measured here: 100% of elements, for flat and banked ramps,
a ragged hidden width, and c' landing on 0.0).

The Pallas kernel (run in interpret mode, as the JAX tests run it) decodes
in closed form instead of by table lookup, so against it the codes are
bitwise and the values agree within 1e-6 absolute (6e-8 was seen on h',
5e-7 on c' of magnitude ~6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as JBK
from repro.core import nladc as JN
from repro.kernels import ops as JOPS
from repro_torch.core import backend as TBK
from repro_torch.core import nladc as TN
from repro_torch.kernels import lstm_cell as TLC
from repro_torch.kernels import ref as TREF

PRESET = "paper-infer"


def _ramps():
    from repro.core.device import get_device
    dev = get_device(PRESET)
    return (dev.deploy_ramp(JN.build_ramp("sigmoid", 5)),
            dev.deploy_ramp(JN.build_ramp("tanh", 5)))


def _inputs(b, h, seed, tanh_ramp):
    rng = np.random.default_rng(seed)
    gates = rng.normal(0, 2.0, (b, 4 * h)).astype(np.float32)
    c = rng.normal(0, 1.5, (b, h)).astype(np.float32)
    # c' = fma(f, 0, i*0) = 0.0 exactly, meeting the tanh ramp's threshold
    # at 0.0: a gate input just above it decodes to the table's 0.0 entry
    yt = np.asarray(tanh_ramp.y_table, np.float32)
    zero_code = int(np.flatnonzero(yt == 0.0)[0])
    thr = np.asarray(tanh_ramp.thresholds, np.float32)
    a_in = np.float32(0.5) * (thr[zero_code - 1] + thr[zero_code])
    k = max(1, h // 4)
    c[:, :k] = 0.0
    gates[:, h:h + k] = a_in
    return gates, c


def _banked(thr64, width, tile_cols, rng):
    """(n_banks, P) thresholds: the ramp shifted per col-tile."""
    bm_j = JN.bank_map_for(width, tile_cols)
    shift = rng.normal(0, 0.03, (bm_j.n_banks, 1))
    return (np.asarray(thr64)[None, :] + shift).astype(np.float32), bm_j


def _jax_ref(gates, c, sig_ramp, tanh_ramp, bank_map=None, sig_thr=None,
             tanh_thr=None):
    """``jax.jit(RefBackend().lstm_gates)``; banked thresholds are traced
    (n_banks, P) arrays under a static bank map."""
    s, t = JN.NLADC(sig_ramp), JN.NLADC(tanh_ramp)

    def wrap(thr):
        if thr is None or bank_map is None:
            return thr
        return JN.BankedThresholds(thr, bank_map)

    fn = jax.jit(lambda g, cc, st, tt: JBK.RefBackend().lstm_gates(
        g, cc, s, t, sig_thr=wrap(st), tanh_thr=wrap(tt)))
    h, cn = fn(jnp.asarray(gates), jnp.asarray(c), sig_thr, tanh_thr)
    return np.asarray(h), np.asarray(cn)


def _port(gates, c, sig_ramp, tanh_ramp, sig_thr=None, tanh_thr=None):
    """The port's plain kernel version (the CPU path of the wrapper) and
    its ref backend, on the same operands."""
    s, t = TN.NLADC(sig_ramp), TN.NLADC(tanh_ramp)
    st = s.thresholds if sig_thr is None else sig_thr
    tt = t.thresholds if tanh_thr is None else tanh_thr
    dense = [x.per_column if isinstance(x, TN.BankedThresholds) else x
             for x in (st, tt)]
    g, cc = torch.from_numpy(gates), torch.from_numpy(c)
    launches = TLC.lstm_gates.launches
    plain = TLC.lstm_gates(g, cc, dense[0], s.y_table, dense[1], t.y_table)
    assert TLC.lstm_gates.launches == launches      # CPU: no kernel launch
    ref = TBK.get_backend("ref").lstm_gates(g, cc, s, t, sig_thr=st,
                                            tanh_thr=tt)
    return [x.numpy() for x in plain], [x.numpy() for x in ref]


@pytest.mark.parametrize("b,h", [(16, 64), (5, 37), (3, 2016)])
def test_plain_equals_jit_ref_bitwise_flat(b, h):
    sig, tnh = _ramps()
    gates, c = _inputs(b, h, b * 100 + h, tnh)
    want_h, want_c = _jax_ref(gates, c, sig, tnh)
    (ph, pc), (rh, rc) = _port(gates, c, sig, tnh)
    for got_h, got_c in ((ph, pc), (rh, rc)):
        np.testing.assert_array_equal(got_c, want_c)
        np.testing.assert_array_equal(got_h, want_h)
    assert np.count_nonzero(want_c == 0.0) >= b       # the 0.0 case occurred


@pytest.mark.parametrize("b,h,tile_cols", [(8, 64, 16), (4, 37, 16)])
def test_plain_equals_jit_ref_bitwise_banked(b, h, tile_cols):
    sig, tnh = _ramps()
    gates, c = _inputs(b, h, 7 + h, tnh)
    rng = np.random.default_rng(h)
    sthr, bm_j = _banked(sig.thresholds, h, tile_cols, rng)
    tthr, _ = _banked(tnh.thresholds, h, tile_cols, rng)
    want_h, want_c = _jax_ref(gates, c, sig, tnh, bm_j, jnp.asarray(sthr),
                              jnp.asarray(tthr))
    bm_t = TN.bank_map_for(h, tile_cols)
    (ph, pc), (rh, rc) = _port(
        gates, c, sig, tnh,
        TN.BankedThresholds(torch.from_numpy(sthr), bm_t),
        TN.BankedThresholds(torch.from_numpy(tthr), bm_t))
    for got_h, got_c in ((ph, pc), (rh, rc)):
        np.testing.assert_array_equal(got_c, want_c)
        np.testing.assert_array_equal(got_h, want_h)


@pytest.mark.parametrize("banked", (False, True))
def test_against_pallas_interpret(banked):
    sig, tnh = _ramps()
    b, h, tile_cols = 6, 40, 16
    gates, c = _inputs(b, h, 3, tnh)
    jst = jtt = None
    tst = ttt = None
    if banked:
        rng = np.random.default_rng(9)
        sthr, bm_j = _banked(sig.thresholds, h, tile_cols, rng)
        tthr, _ = _banked(tnh.thresholds, h, tile_cols, rng)
        jst = JN.BankedThresholds(jnp.asarray(sthr), bm_j)
        jtt = JN.BankedThresholds(jnp.asarray(tthr), bm_j)
        bm_t = TN.bank_map_for(h, tile_cols)
        tst = TN.BankedThresholds(torch.from_numpy(sthr), bm_t)
        ttt = TN.BankedThresholds(torch.from_numpy(tthr), bm_t)
    kh, kc = JOPS.lstm_gates(jnp.asarray(gates), jnp.asarray(c), sig, tnh,
                             sig_thresholds=jst, tanh_thresholds=jtt)
    kh, kc = np.array(kh), np.array(kc)
    (ph, pc), _ = _port(gates, c, sig, tnh, tst, ttt)
    st = None if tst is None else tst.per_column
    tt = None if ttt is None else ttt.per_column
    oh, oc = TREF.lstm_gates(torch.from_numpy(gates), torch.from_numpy(c),
                             sig, tnh, st, tt)
    if tt is None:
        tt = torch.from_numpy(np.asarray(tnh.thresholds, np.float32))
    codes_k = TREF.thermometer_count(torch.from_numpy(kc), tt)
    for got_h, got_c in ((ph, pc), (oh.numpy(), oc.numpy())):
        codes = TREF.thermometer_count(torch.from_numpy(got_c), tt)
        np.testing.assert_array_equal(codes.numpy(), codes_k.numpy())
        np.testing.assert_allclose(got_c, kc, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_h, kh, rtol=0, atol=1e-6)


def test_fma_rounds_once():
    # a*b = 1 + 2^-11 + 2^-24 exactly; adding 2^-60 rounds, in float64, to
    # a float32 midpoint, where a second rounding would go to even (down)
    a = torch.tensor([1 + 2 ** -12], dtype=torch.float32)
    c = torch.tensor([2.0 ** -60], dtype=torch.float32)
    want = np.float32(1 + 2 ** -11 + 2 ** -23)
    naive = (a.double() * a.double() + c.double()).float()
    assert naive.item() != want
    assert TREF.fma_f32(a, a, c).item() == want
    assert TREF.fma_f32(a, a, -c).item() == np.float32(1 + 2 ** -11)
    rng = np.random.default_rng(0)
    x, y, z = (torch.from_numpy(rng.normal(0, 3, 4096).astype(np.float32))
               for _ in range(3))
    want = (x.double() * y.double() + z.double()).float()
    np.testing.assert_array_equal(TREF.fma_f32(x, y, z).numpy(),
                                  want.numpy())


def test_wrapper_rejects_bad_operands():
    s, t = TN.NLADC(TN.build_ramp("sigmoid", 5)), \
        TN.NLADC(TN.build_ramp("tanh", 5))
    g, c = torch.zeros(2, 8), torch.zeros(2, 2)
    ok = (g, c, s.thresholds, s.y_table, t.thresholds, t.y_table)
    TLC.lstm_gates(*ok)
    bad = [(torch.zeros(2, 8, dtype=torch.float64),) + ok[1:],
           (g, torch.zeros(2, 3)) + ok[2:],
           (g, c, torch.zeros(3, 32)) + ok[3:],
           (g, c, s.thresholds, torch.zeros(32)) + ok[4:],
           (torch.zeros(8, 2).t(),) + ok[1:]]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            TLC.lstm_gates(*args)
    with pytest.raises(ValueError, match="CUDA"):
        TBK.get_backend("cuda").lstm_gates(g, c, s, t)
    # the elementwise NL-ADC is a kernel now: a CPU tensor is refused too
    with pytest.raises(ValueError, match="CUDA"):
        TBK.get_backend("cuda").nladc(g, s)


def test_library_declares_pointer_arguments(monkeypatch):
    """Every pointer and the stream go through ctypes as ``c_void_p``; an
    undeclared argument would be cut to a 32-bit int."""
    import ctypes
    from types import SimpleNamespace

    fake = SimpleNamespace(
        lstm_gates_launch=SimpleNamespace(argtypes=None, restype=None),
        cuda_error_string=SimpleNamespace(argtypes=None, restype=None))
    monkeypatch.setattr(TLC._build, "load", lambda name: fake)
    lib = TLC.library()
    fn = lib.lstm_gates_launch
    assert fn.argtypes == [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert lib.cuda_error_string.restype is ctypes.c_char_p


@pytest.mark.cuda
def test_kernel_equals_plain_on_card():
    """Run on a GPU host: ``pytest -m cuda tests/``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    sig, tnh = _ramps()
    s, t = TN.NLADC(TN.build_ramp("sigmoid", 5), dev), \
        TN.NLADC(TN.build_ramp("tanh", 5), dev)
    for b, h, tile_cols in [(16, 2016, 0), (16, 2016, 512), (7, 32, 0)]:
        gates, c = _inputs(b, h, h, tnh)
        g, cc = torch.from_numpy(gates).to(dev), torch.from_numpy(c).to(dev)
        st, tt = s.thresholds, t.thresholds
        if tile_cols:
            bm = TN.bank_map_for(h, tile_cols)
            rng = np.random.default_rng(1)
            st = TN.BankedThresholds(torch.from_numpy(
                _banked(sig.thresholds, h, tile_cols, rng)[0]).to(dev),
                bm).per_column
            tt = TN.BankedThresholds(torch.from_numpy(
                _banked(tnh.thresholds, h, tile_cols, rng)[0]).to(dev),
                bm).per_column
        args = (g, cc, st, s.y_table, tt, t.y_table)
        n0 = TLC.lstm_gates.launches
        kh, kc = TLC.lstm_gates(*args)
        ph, pc = TLC.lstm_gates_plain(*args)
        torch.cuda.synchronize()
        assert TLC.lstm_gates.launches == n0 + 1
        assert torch.equal(kh, ph) and torch.equal(kc, pc)
