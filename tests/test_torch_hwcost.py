"""``repro_torch.core.hwcost`` against the JAX package's ``core/hwcost.py``.

The cost model is plain arithmetic, so every function gives the
reference's floats to the bit: every macro, tail and system builder over
a sweep of widths, bits and processor counts (each module's area, energy,
latency and op count, and the derived metrics), ``af_latency_clocks``,
the constants; and the port alone meets the paper's Tab. S3-S17 values
as the reference's own ``tests/test_hwcost.py`` holds them.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import hwcost as JHW
from repro_torch.core import hwcost as HW

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

METRICS = ("area_um2", "energy_pj", "latency_ns", "n_mac_ops",
           "throughput_tops", "power_mw", "tops_per_w", "tops_per_mm2")


def _flat(cost):
    """Every number of a MacroCost / SystemCost, in order."""
    out = {}
    for m in METRICS:
        if hasattr(cost, m):
            out[m] = getattr(cost, m)
    if hasattr(cost, "table"):
        out["table"] = cost.table()
    for f in dataclasses.fields(cost):
        v = getattr(cost, f.name)
        if isinstance(v, (list, tuple)):
            out[f.name] = [_flat(x) if dataclasses.is_dataclass(x)
                           else x for x in v]
        elif dataclasses.is_dataclass(v):
            out[f.name] = _flat(v)
        else:
            out[f.name] = v
    return out


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert repr(fa) == repr(fb)          # floats to the bit, same order


MACRO_CASES = [(72, 128, 5), (633, 512, 5), (633, 8064, 4), (32, 12, 3),
               (2048, 11008, 5), (504, 50, 5), (1, 1, 1)]


@pytest.mark.parametrize("rows,cols,bits", MACRO_CASES)
def test_macros_are_the_references(rows, cols, bits):
    for kw in ({}, {"n_nladc_cols": 7}, {"phases": 3}):
        _same(HW.nladc_macro(rows, cols, bits_in=bits, bits_out=bits, **kw),
              JHW.nladc_macro(rows, cols, bits_in=bits, bits_out=bits, **kw))
    for k, n_cyc in ((1, 2), (8, 2), (32, 1)):
        _same(HW.conventional_macro(rows, cols, bits_in=bits,
                                    bits_out=bits, k_procs=k, n_cyc=n_cyc),
              JHW.conventional_macro(rows, cols, bits_in=bits,
                                     bits_out=bits, k_procs=k,
                                     n_cyc=n_cyc))
    _same(HW.digital_lut_macro(rows, cols, bits_in=bits, bits_out=bits),
          JHW.digital_lut_macro(rows, cols, bits_in=bits, bits_out=bits))


@pytest.mark.parametrize("bits", [3, 4, 5])
def test_systems_and_tails_are_the_references(bits):
    for conventional in (False, True):
        for k in (1, 8):
            _same(HW.kws_system(bits, conventional=conventional, k_procs=k),
                  JHW.kws_system(bits, conventional=conventional, k_procs=k))
            _same(HW.nlp_system(bits, conventional=conventional, k_procs=k),
                  JHW.nlp_system(bits, conventional=conventional, k_procs=k))
            _same(HW.kws_macro(bits, conventional=conventional, k_procs=k),
                  JHW.kws_macro(bits, conventional=conventional, k_procs=k))
            _same(HW.nlp_macro(bits, conventional=conventional, k_procs=k),
                  JHW.nlp_macro(bits, conventional=conventional, k_procs=k))
    for n_hidden, n_procs in ((32, 1), (2016, 8), (2016, 32)):
        _same(HW.lstm_elementwise_tail(n_hidden, n_procs),
              JHW.lstm_elementwise_tail(n_hidden, n_procs))


def test_af_latency_and_constants_are_the_references():
    for args in ((32, 128), (8, 512), (8, 2016), (5, 7)):
        for kw in ({}, {"af_included": True}, {"n_cyc": 3, "k_procs": 4}):
            assert HW.af_latency_clocks(*args, **kw) == \
                JHW.af_latency_clocks(*args, **kw)
    names = [n for n in dir(JHW) if n.isupper()]
    assert names and names == [n for n in dir(HW) if n.isupper()]
    for n in names:
        assert repr(getattr(HW, n)) == repr(getattr(JHW, n)), n


def test_published_tables():
    """Tab. S3, S4, S5, S9, S12, S17 and Tab. 2 as the reference's own
    tests hold them."""
    m = HW.nladc_macro(72, 128, bits_in=5, bits_out=5)
    np.testing.assert_allclose(m.area_um2, 2447.57, rtol=0.02)
    np.testing.assert_allclose(m.energy_pj, 557.79, rtol=0.05)
    np.testing.assert_allclose(m.latency_ns, 65.0, atol=1.0)
    m = HW.conventional_macro(72, 128, bits_in=5, bits_out=5, k_procs=1,
                              n_cyc=2)
    np.testing.assert_allclose(m.area_um2, 6275.01, rtol=0.02)
    np.testing.assert_allclose(m.energy_pj, 829.26, rtol=0.05)
    np.testing.assert_allclose(m.latency_ns, 321.0, atol=1.0)
    ours, conv = HW.kws_macro(5), HW.kws_macro(5, conventional=True)
    np.testing.assert_allclose(ours.tops_per_w, 33.04, rtol=0.06)
    np.testing.assert_allclose(ours.tops_per_mm2, 115.86, rtol=0.06)
    np.testing.assert_allclose(conv.tops_per_w, 23.26, rtol=0.06)
    np.testing.assert_allclose(conv.tops_per_mm2, 9.56, rtol=0.07)
    eff = [HW.kws_macro(b).tops_per_w for b in (5, 4, 3)]
    np.testing.assert_allclose(eff, [33.04, 66.24, 133.77], rtol=0.08)
    ours = HW.nlp_macro(5)
    conv8 = HW.nlp_macro(5, conventional=True, k_procs=8)
    np.testing.assert_allclose(ours.tops_per_w, 60.77, rtol=0.08)
    np.testing.assert_allclose(conv8.tops_per_w, 55.11, rtol=0.10)
    np.testing.assert_allclose(ours.latency_ns, 129.0, atol=2.0)
    np.testing.assert_allclose(conv8.latency_ns, 2145.0, rtol=0.02)
    ours, conv = HW.kws_system(5), HW.kws_system(5, conventional=True)
    np.testing.assert_allclose(ours.tops_per_w, 31.33, rtol=0.08)
    np.testing.assert_allclose(conv.tops_per_w, 21.27, rtol=0.10)
    np.testing.assert_allclose(ours.tops_per_mm2 / conv.tops_per_mm2,
                               39.48 / 6.41, rtol=0.15)
    ours = HW.nlp_system(5)
    conv = HW.nlp_system(5, conventional=True, k_procs=8)
    np.testing.assert_allclose(ours.throughput_tops / conv.throughput_tops,
                               4.9, rtol=0.25)
    assert 1.0 < ours.tops_per_w / conv.tops_per_w < 1.5
    np.testing.assert_allclose(ours.tops_per_mm2 / conv.tops_per_mm2,
                               7.9, rtol=0.30)
    assert HW.af_latency_clocks(32, 128, af_included=True) == 32
    assert 250 <= HW.af_latency_clocks(8, 128, n_cyc=2, k_procs=1) <= 270
    assert 1020 <= HW.af_latency_clocks(8, 512, n_cyc=2, k_procs=1) <= 1040
