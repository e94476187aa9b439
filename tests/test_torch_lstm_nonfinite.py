"""NaN and +-inf through the fused LSTM tail, on the port and the Pallas
kernel.

Every NL-ADC of the tail is the explicit count ``sum_k [x > V_k]``: in the
Pallas kernel (``repro.kernels.lstm_cell.lstm_gates_pallas``, run in
interpret mode as ``tests/test_torch_lstm_cell.py`` runs it) and in the
port's plain version (``repro_torch.kernels.lstm_cell.lstm_gates_plain``,
which the CUDA kernel is held to bitwise on the card).  So a NaN gate or a
NaN ``c'`` counts 0, +inf counts every threshold and -inf none, flat and
banked, on both.

With count ramps (thresholds ``[-1, 0, 1]``, ``y(n) = n``) the Pallas
kernel's closed-form decode is the lookup exactly, the gate values are
small integers and ``c`` is dyadic, so ``f*c + i*a`` rounds nowhere and the
two outputs must be equal, NaN for NaN.  With the 5-bit sigmoid and tanh
ramps the decodes differ by float rounding only: the codes of ``c'`` and the
NaN and infinity pattern of both outputs must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nladc as JN
from repro.kernels.lstm_cell import lstm_gates_pallas
from repro_torch.kernels import lstm_cell as TLC
from repro_torch.kernels.ref import thermometer_count

THR = np.array([-1.0, 0.0, 1.0], np.float32)
NAN, INF = np.float32(np.nan), np.float32(np.inf)
H = 8
# gate values per column, [f | a | i | o], and c: every gate sees NaN, +inf
# and -inf somewhere, and so does c
GF = [NAN, INF, -INF, 0.5, 2.0, -0.5, 0.5, NAN]
GA = [INF, NAN, 0.5, -INF, 0.5, 2.0, NAN, -2.0]
GI = [-INF, 0.5, NAN, INF, 0.5, 0.5, INF, 1.0]
GO = [0.5, -INF, INF, NAN, 1.5, 0.5, -0.5, 1.0]
C = [2.0, 0.5, -1.25, 0.0, NAN, INF, -INF, INF]


def _count_ramp(kind):
    """A ramp with the thresholds above and ``y(n) = n`` (P = 3)."""
    ramp = JN.build_ramp(kind, 2).with_thresholds(THR.astype(np.float64))
    return dataclasses.replace(ramp, y_table=np.arange(len(THR) + 1.0),
                               split_index=-1, monotonic_split=False)


def _inputs():
    gates = np.array([GF + GA + GI + GO], np.float32)
    c = np.array([C], np.float32)
    # a second row with the specials moved one column on
    gates = np.concatenate([gates, np.roll(gates.reshape(4, H), 1, axis=1)
                            .reshape(1, 4 * H)])
    c = np.concatenate([c, np.roll(c, 1, axis=1)])
    return gates, c


def _pallas(gates, c, sig, tnh, banked):
    kw = {}
    if banked:
        kw = dict(sig_thresholds=jnp.asarray(np.tile(sig.thresholds, (H, 1))),
                  tanh_thresholds=jnp.asarray(
                      np.tile(tnh.thresholds, (H, 1))))
    h, c_new = lstm_gates_pallas(jnp.asarray(gates), jnp.asarray(c), sig, tnh,
                                 block=gates.shape[:1] + (H,),
                                 interpret=True, **kw)
    return np.array(h), np.array(c_new)


def _port(gates, c, sig, tnh, banked):
    def thr(ramp):
        t = torch.tensor(np.asarray(ramp.thresholds, np.float32))
        return t.expand(H, -1).contiguous() if banked else t

    def table(ramp):
        return torch.tensor(np.asarray(ramp.y_table, np.float32))

    args = (torch.from_numpy(gates), torch.from_numpy(c), thr(sig),
            table(sig), thr(tnh), table(tnh))
    n0 = TLC.lstm_gates.launches
    h, c_new = TLC.lstm_gates(*args)         # a CPU tensor: the plain version
    assert TLC.lstm_gates.launches == n0
    ph, pc = TLC.lstm_gates_plain(*args)
    assert torch.equal(h.isnan(), ph.isnan())
    assert torch.equal(torch.nan_to_num(h), torch.nan_to_num(ph))
    assert torch.equal(torch.nan_to_num(c_new), torch.nan_to_num(pc))
    return h.numpy(), c_new.numpy(), args[4]


@pytest.mark.parametrize("banked", [False, True])
def test_count_ramps_give_the_pallas_kernels_codes(banked):
    sig, tnh = _count_ramp("sigmoid"), _count_ramp("tanh")
    gates, c = _inputs()
    kh, kc = _pallas(gates, c, sig, tnh, banked)
    ph, pc, _ = _port(gates, c, sig, tnh, banked)
    np.testing.assert_array_equal(pc, kc)
    np.testing.assert_array_equal(ph, kh)
    # column 0 by hand: f = #(NaN) = 0, a = #(+inf) = 3, i = #(-inf) = 0,
    # o = #(0.5) = 2; c' = 0 * 2 + 0 * 3 = 0, whose tanh code is #(0 > t) = 1
    assert (pc[0, 0], ph[0, 0]) == (0.0, 2.0)
    # column 4: c NaN, so c' is NaN and counts 0 in the tanh NL-ADC: h' = 0;
    # column 5: c +inf and f = #(-0.5) = 1, so c' = +inf counts all 3 and
    # h' = o * 3 with o = #(0.5) = 2
    assert np.isnan(pc[0, 4]) and ph[0, 4] == 0.0
    assert np.isposinf(pc[0, 5]) and ph[0, 5] == 2.0 * 3.0


@pytest.mark.parametrize("banked", [False, True])
def test_five_bit_ramps_give_the_pallas_kernels_codes(banked):
    sig, tnh = JN.build_ramp("sigmoid", 5), JN.build_ramp("tanh", 5)
    gates, c = _inputs()
    kh, kc = _pallas(gates, c, sig, tnh, banked)
    ph, pc, tthr = _port(gates, c, sig, tnh, banked)
    for got, want in ((pc, kc), (ph, kh)):
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.array_equal(np.isposinf(got), np.isposinf(want))
        assert np.array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(
        thermometer_count(torch.from_numpy(pc), tthr).numpy(),
        thermometer_count(torch.from_numpy(kc), tthr).numpy())
    finite = np.isfinite(kh)
    np.testing.assert_allclose(ph[finite], kh[finite], rtol=0, atol=1e-6)
