"""repro_torch's device model, calibration and drift against the JAX
package's, bitwise.

The build stage draws from ``numpy.random.Generator`` streams salted with
``zlib.crc32`` of the ramp identity in both packages, so programmed
thresholds (and every intermediate) must be identical, also under the
line stage's IR-aware ramp rebuild (``paper-ir``, ``stressed-ir``: per-bank
wordline position, bank-aware redundancy placement).
"""

import json

import numpy as np
import pytest

from repro.core import calibration as JCAL
from repro.core import crossbar as JCB
from repro.core import device as JD
from repro.core import nladc as JN
from repro_torch.core import calibration as TCAL
from repro_torch.core import crossbar as TCB
from repro_torch.core import device as TD
from repro_torch.core import nladc as TN

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

PRESETS = ("paper-infer", "aged-1day", "stressed", "paper-ir",
           "stressed-ir")


@pytest.mark.parametrize("act", ("sigmoid", "tanh"))
@pytest.mark.parametrize("preset", PRESETS)
def test_deploy_ramp_bitwise(preset, act):
    jd, td = JD.get_device(preset), TD.get_device(preset)
    for bits in (4, 5):
        a = jd.deploy_ramp(JN.build_ramp(act, bits))
        b = td.deploy_ramp(TN.build_ramp(act, bits))
        np.testing.assert_array_equal(a.thresholds, b.thresholds)
        np.testing.assert_array_equal(a.y_table, b.y_table)


@pytest.mark.parametrize("preset", PRESETS)
def test_deploy_ramp_bank_bitwise(preset):
    jd, td = JD.get_device(preset), TD.get_device(preset)
    a = jd.deploy_ramp_bank(JN.build_ramp("tanh", 5), 4)
    b = td.deploy_ramp_bank(TN.build_ramp("tanh", 5), 4)
    assert len(a) == len(b) == 4
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.thresholds, rb.thresholds)
    # distinct col-tiles are distinct chips
    assert not np.array_equal(b[0].thresholds, b[1].thresholds)


@pytest.mark.parametrize("name", sorted(JD.device_names()))
def test_to_dict_matches_and_round_trips(name):
    jd, td = JD.get_device(name), TD.get_device(name)
    assert td.to_dict() == jd.to_dict()
    wire = json.loads(json.dumps(td.to_dict()))
    assert TD.device_from_dict(wire) == td
    assert JD.device_from_dict(wire) == jd


def test_registry_and_resolution_match(monkeypatch):
    assert TD.device_names() == JD.device_names()
    monkeypatch.setenv("REPRO_DEVICE", "stressed")
    assert TD.resolve_device("").name == "stressed"
    assert TD.resolve_device("paper-infer") is TD.PAPER_INFER
    with pytest.raises(KeyError):
        TD.get_device("no-such-chip")


@pytest.mark.parametrize("frac", (0.25, 1.0))
@pytest.mark.parametrize("preset", ("paper-ir", "stressed-ir"))
def test_line_rebuild_bitwise(preset, frac):
    jd, td = JD.get_device(preset), TD.get_device(preset)
    g = np.random.default_rng(3).uniform(0, 150, 32)
    a = jd.line_rebuild(frac)(JN.build_ramp("tanh", 5), g)
    b = td.line_rebuild(frac)(TN.build_ramp("tanh", 5), g)
    np.testing.assert_array_equal(a.thresholds, b.thresholds)
    # the wires lower every level's step: not the ideal-wire rebuild
    plain = TN.ramp_from_conductances(TN.build_ramp("tanh", 5), g)
    assert not np.array_equal(b.thresholds, plain.thresholds)
    assert td.replace(line=None).line_rebuild(frac) is None


@pytest.mark.parametrize("preset", ("paper-ir", "stressed-ir", "stressed"))
def test_bank_geometry_bitwise(preset):
    jd, td = JD.get_device(preset), TD.get_device(preset)
    for n in (1, 2, 3, 4, 16):
        assert [td.bank_line_frac(j, n) for j in range(n)] == \
            [jd.bank_line_frac(j, n) for j in range(n)]
        assert td.worst_bank(n) == jd.worst_bank(n)
        assert [td.bank_device(j, n).to_dict() for j in range(n)] == \
            [jd.bank_device(j, n).to_dict() for j in range(n)]
    if preset == "stressed-ir":
        # double sourcing: worst in the middle, redundancy spent there
        assert td.worst_bank(4) == 2
        assert [td.bank_device(j, 4).redundancy.n_copies
                for j in range(4)] == [1, 1, 4, 1]
    if preset == "stressed":
        assert td.bank_device(0, 4) is td


@pytest.mark.parametrize("copies", (1, 4))
def test_calibration_with_line_rebuild_bitwise(copies):
    """``program_with_redundancy``'s INL selection judges the wire-read
    thresholds (4 copies, as ``stressed-ir`` programs them)."""
    jd, td = JD.get_device("stressed-ir"), TD.get_device("stressed-ir")
    ja, ta = JN.build_ramp("sigmoid", 5), TN.build_ramp("sigmoid", 5)
    jr, tr = np.random.default_rng(12), np.random.default_rng(12)
    kw = dict(sigma_us=5.34, stuck_off_prob=0.02)
    if copies > 1:
        a = JCAL.program_with_redundancy(ja, jr, copies=copies,
                                         rebuild=jd.line_rebuild(0.5), **kw)
        b = TCAL.program_with_redundancy(ta, tr, copies=copies,
                                         rebuild=td.line_rebuild(0.5), **kw)
    else:
        a = JCAL.program_ramp(ja, jr, rebuild=jd.line_rebuild(0.5), **kw)
        b = TCAL.program_ramp(ta, tr, rebuild=td.line_rebuild(0.5), **kw)
    np.testing.assert_array_equal(a.programmed.thresholds,
                                  b.programmed.thresholds)
    np.testing.assert_array_equal(a.conductances_us, b.conductances_us)
    assert a.n_cali_devices == b.n_cali_devices
    assert a.inl() == b.inl()


def test_tile_rng_bitwise():
    jd, td = JD.get_device("paper-ir"), TD.get_device("paper-ir")
    for key, salt in (("['lstm']['w_gates']", (0, 0, 3)), ("k", ())):
        np.testing.assert_array_equal(jd.tile_rng(key, *salt).random(8),
                                      td.tile_rng(key, *salt).random(8))


@pytest.mark.parametrize("copies", (1, 4))
def test_calibration_pipeline_bitwise(copies):
    ja, ta = JN.build_ramp("sigmoid", 5), TN.build_ramp("sigmoid", 5)
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    if copies > 1:
        a = JCAL.program_with_redundancy(ja, jr, copies=copies,
                                         stuck_off_prob=0.02)
        b = TCAL.program_with_redundancy(ta, tr, copies=copies,
                                         stuck_off_prob=0.02)
    else:
        a = JCAL.program_ramp(ja, jr, stuck_off_prob=0.02)
        b = TCAL.program_ramp(ta, tr, stuck_off_prob=0.02)
    np.testing.assert_array_equal(a.programmed.thresholds,
                                  b.programmed.thresholds)
    np.testing.assert_array_equal(a.conductances_us, b.conductances_us)
    assert a.n_cali_devices == b.n_cali_devices
    assert a.inl() == b.inl()


def test_one_point_calibrate_bank_bitwise():
    ja, ta = JN.build_ramp("tanh", 5), TN.build_ramp("tanh", 5)
    g = np.random.default_rng(5).uniform(0, 150, (3, 32))
    progs_j = [JN.ramp_from_conductances(ja, gi) for gi in g]
    progs_t = [TN.ramp_from_conductances(ta, gi) for gi in g]
    a, na = JCAL.one_point_calibrate_bank(progs_j, ja,
                                          np.random.default_rng(2))
    b, nb = TCAL.one_point_calibrate_bank(progs_t, ta,
                                          np.random.default_rng(2))
    assert na == nb
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.thresholds, rb.thresholds)


def test_drift_model_bitwise():
    g = np.random.default_rng(1).uniform(0, 150, 256)
    g[:3] = (0.0, 150.0, 75.0)
    a = JCB.DriftModel().drift(g, 86_400.0, np.random.default_rng(4))
    b = TCB.DriftModel().drift(g, 86_400.0, np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)
    assert (TCB.W_CLIP, TCB.GAMMA_US, TCB.READ_SIGMA_W) == \
        (JCB.W_CLIP, JCB.GAMMA_US, JCB.READ_SIGMA_W)
