"""The exact nodal solve (``repro_torch.core.circuit``, float64 torch,
preconditioned CG with iterative refinement) against the JAX package's
(``repro.core.circuit``, scipy's sparse LU) at arrays of at most 32 x 32,
both sourcing modes and three wire resistances.

Every public function is held at rtol 1e-9 (atol 0): node voltages,
column currents, the single-polarity and differential MACs, both
effective matrices; the ramp attenuation (a closed form) at rtol 1e-12.
The KCL residual of the port's solution stays within its stated
tolerance (``circuit.RTOL`` of the largest wire current) and of the
reference's check; the reference's solution measured by the port's
``kcl_residual`` passes the same check.  Superposition: ``x @ G_eff``
equals the full solve.  The ``r <= 0`` guard and the argument checks
raise as the reference's do.
"""

import numpy as np
import pytest
import torch

from repro.core import circuit as JC
from repro_torch.core import circuit as TC

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

RTOL = 1e-9
CPU = dict(device="cpu")
SHAPES = ((8, 8), (32, 32), (16, 32), (32, 16), (1, 5), (5, 1))
CORNERS = [(shape, r, s) for shape in SHAPES for r in (0.5, 1.0, 2.0)
           for s in ("single", "double")]


def _case(shape, seed=0):
    rng = np.random.default_rng(seed + shape[0] * 100 + shape[1])
    w = rng.uniform(-1.5, 1.5, shape)
    x = rng.uniform(-1, 1, (4, shape[0]))
    return w, x


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=rtol, atol=0)


@pytest.mark.parametrize("shape,r,sourcing", CORNERS)
def test_exact_mac_weights_and_currents(shape, r, sourcing):
    w, x = _case(shape)
    systems = []
    for xi in x:
        want = JC.exact_mac_weights(w, xi, r, r, sourcing)
        _close(TC.exact_mac_weights(w, xi, r, r, sourcing, systems=systems,
                                    **CPU), want)
    g_pos, _ = JC.weights_to_conductance_pairs(w)
    want = np.stack([JC.solve_nodal(g_pos, xi, r, r, sourcing) for xi in x])
    _close(TC.solve_nodal(g_pos, x, r, r, sourcing, **CPU), want)
    _close(TC.exact_mac(g_pos, x[0], r, r, sourcing, **CPU),
           JC.exact_mac(g_pos, x[0], r, r, sourcing))
    for s in systems:
        assert 0 < s.iterations and s.residual_ua <= s.tolerance(x)
        assert s.tolerance(x) == TC.RTOL * max(s.g_wl, s.g_bl) * max(
            1.0, float(np.abs(x).max()))


@pytest.mark.parametrize("sourcing", ("single", "double"))
@pytest.mark.parametrize("shape", ((8, 8), (32, 32), (16, 32), (32, 1)))
def test_effective_matrices_and_superposition(shape, sourcing):
    w, x = _case(shape, seed=1)
    r_wl, r_bl = 1.0, 2.0
    _close(TC.exact_effective_weights(w, r_wl, r_bl, sourcing, **CPU),
           JC.exact_effective_weights(w, r_wl, r_bl, sourcing))
    g_pos, g_neg = JC.weights_to_conductance_pairs(w)
    g_eff = TC.exact_effective_conductances(g_neg, r_wl, r_bl, sourcing,
                                            **CPU)
    _close(g_eff, JC.exact_effective_conductances(g_neg, r_wl, r_bl,
                                                  sourcing))
    # superposition: the effective matrix reproduces the full solve
    full = TC.solve_nodal(g_neg, x, r_wl, r_bl, sourcing, **CPU)
    _close(torch.from_numpy(x) @ g_eff, full.numpy())


@pytest.mark.parametrize("sourcing", ("single", "double"))
def test_node_voltages_and_kcl_residual(sourcing):
    w, x = _case((12, 20), seed=2)
    g, _ = JC.weights_to_conductance_pairs(w)
    jsys = JC.NodalSystem(g, 1.0, 1.0, sourcing)
    tsys = TC.NodalSystem(g, 1.0, 1.0, sourcing, **CPU)
    assert tsys.n_unknowns == jsys.n_unknowns == 2 * 12 * 20
    v_ref = jsys.node_voltages(x[0])
    v = tsys.node_voltages(x[0])
    assert v.shape == (tsys.n_unknowns,)
    _close(v, v_ref)
    # the batched solve is the per-row one
    vb = tsys.node_voltages(x)
    assert vb.shape == (4, tsys.n_unknowns)
    _close(vb[0], v_ref)
    scale = max(1.0, float(g.max()) * float(np.abs(x[0]).max()))
    for res in (tsys.kcl_residual(v, x[0]), tsys.kcl_residual(v_ref, x[0]),
                jsys.kcl_residual(v.numpy(), x[0])):
        assert res <= 1e-6 * scale
    assert tsys.kcl_residual(v, x[0]) <= TC.RTOL * tsys.g_wl
    # a wrong solution shows: one volt off at one node
    bad = v.clone()
    bad[5] += 1.0
    assert tsys.kcl_residual(bad, x[0]) > 1e3
    _close(tsys.output_currents(x[0], check_residual=True),
           jsys.output_currents(x[0], check_residual=True))


@pytest.mark.parametrize("segments", (0.0, 3.0))
def test_exact_ramp_attenuation(segments):
    g = np.random.default_rng(3).uniform(0, 150, (4, 32))
    _close(TC.exact_ramp_attenuation(g, 1.0, 2.5, segments, **CPU),
           JC.exact_ramp_attenuation(g, 1.0, 2.5, segments), rtol=1e-12)


@pytest.mark.parametrize("r_wl,r_bl", [(0.0, 1.0), (1.0, 0.0), (-1.0, 1.0)])
def test_the_oracle_needs_positive_wires(r_wl, r_bl):
    g = np.full((4, 4), 50.0)
    for mod, kw in ((JC, {}), (TC, CPU)):
        with pytest.raises(ValueError, match="r > 0"):
            mod.NodalSystem(g, r_wl, r_bl, **kw)


def test_argument_checks():
    g = np.full((4, 4), 50.0)
    with pytest.raises(ValueError, match="2D"):
        TC.NodalSystem(np.ones(4), 1.0, 1.0, **CPU)
    with pytest.raises(ValueError, match=">= 0"):
        TC.NodalSystem(-g, 1.0, 1.0, **CPU)
    with pytest.raises(ValueError, match="sourcing"):
        TC.NodalSystem(g, 1.0, 1.0, "triple", **CPU)
    with pytest.raises(ValueError, match="shape"):
        TC.NodalSystem(g, 1.0, 1.0, **CPU).node_voltages(np.zeros(5))


def test_zero_drive_and_zero_cells():
    g = np.zeros((3, 4))
    y = TC.solve_nodal(g, np.ones(3), 1.0, 1.0, **CPU)
    assert torch.equal(y, torch.zeros(4, dtype=torch.float64))
    g = np.full((3, 4), 75.0)
    y = TC.solve_nodal(g, np.zeros(3), 1.0, 1.0, **CPU)
    assert torch.equal(y, torch.zeros(4, dtype=torch.float64))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_the_oracle_runs_on_the_card_unless_asked_for_the_cpu():
    with pytest.raises((RuntimeError, AssertionError)):
        TC.NodalSystem(np.full((2, 2), 50.0), 1.0, 1.0)
