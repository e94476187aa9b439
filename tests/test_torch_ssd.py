"""Mamba-2's SSD block: repro_torch's ``nn/ssd.py`` against the JAX
package's ``repro/nn/ssd.py`` under ``jax.jit``, at the mamba2-370m SMOKE
widths (d 64, d_inner 128, 8 heads of 16, state 16, chunk 16), float32,
numpy-seeded inputs and the reference's own init through numpy.

* ``ssd_chunked`` on a sequence of 3 chunks: the output and the final
  state;
* ``ssd_apply`` with ``S % chunk != 0`` (the dt = 0 padding), the NL-ADC
  on the ``ref`` backend (exact ramps, and the ``paper-infer`` preset's
  programmed ones);
* ``ssd_decode`` from a random carried state, one step: the output and
  both state leaves; then 20 steps against ``ssd_apply`` over the same
  sequence;
* the init's tree and shapes, and the decode state's.

Tolerances: the chunked scan sums in another order than the reference's
(a loop over chunks for its ``associative_scan``, torch's einsum
contractions for XLA's), so the outputs are held to atol 2e-5 and the
state to atol 1e-5, both plus rtol 1e-5 (a few float32 ulps of values up
to ~10: ``ssd_chunked``'s unit-normal inputs reach 2.4e-5 absolute at
seed 0); the NL-ADC then keeps every code (an output within LSB/2 of the
reference's: a flipped code would move it by an LSB).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.nn import ssd as JSSD
from repro.nn.model import build as jbuild
from repro_torch import configs as TC
from repro_torch.nn import ssd as TSSD
from repro_torch.nn.model import build as tbuild

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

ATOL = 2e-5
STATE_ATOL = 1e-5
RTOL = 1e-5


def _acts(mode="exact"):
    """(JAX model, port model) at SMOKE, for their dt softplus and z-gate
    silu NL-ADCs (``ref`` backend)."""
    spec = dict(enabled=True, adc_bits=5, activation="silu", mode=mode,
                device="paper-infer" if mode == "infer" else "paper")
    jcfg = JC.get_smoke("mamba2-370m").replace(
        dtype="float32", analog=JSpec(backend="ref", **spec))
    tcfg = TC.get_smoke("mamba2-370m")
    tcfg = tcfg.replace(dtype="float32", analog=dataclasses.replace(
        tcfg.analog, backend="ref", **spec))
    return jbuild(jcfg), tbuild(tcfg, device="cpu")


def _torch(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _block(cfg, seed=0):
    jp = JSSD.ssd_init(jax.random.PRNGKey(seed), cfg.d_model,
                       expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                       d_state=cfg.ssm_state, conv_width=cfg.conv_width)
    return jp, _torch(jp)


def _kw(cfg):
    return dict(expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                d_state=cfg.ssm_state)


def test_ssd_chunked_matches_jax():
    rng = np.random.default_rng(0)
    b, q, nc, h, p, n = 2, 16, 3, 8, 16, 16
    s = q * nc
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    jy, js = jax.jit(lambda *a: JSSD.ssd_chunked(*a, chunk=q))(
        x, dt, a_log, bb, cc)
    ty, ts = TSSD.ssd_chunked(*map(torch.from_numpy, (x, dt, a_log, bb, cc)),
                              chunk=q)
    assert ty.shape == (b, s, h, p) and ts.shape == (b, h, p, n)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=STATE_ATOL)
    with pytest.raises(ValueError, match="not divisible"):
        TSSD.ssd_chunked(*map(torch.from_numpy, (x[:, 1:], dt[:, 1:],
                                                 a_log, bb[:, 1:],
                                                 cc[:, 1:])), chunk=q)


@pytest.mark.parametrize("mode", ["exact", "infer"])
def test_ssd_apply_ragged_sequence_matches_jax(mode):
    jm, tm = _acts(mode)
    cfg = jm.cfg
    jp, tp = _block(cfg)
    s = 2 * cfg.ssm_chunk + 5                     # S % chunk != 0
    x = np.random.default_rng(1).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    jy, js = jax.jit(lambda p, xx: JSSD.ssd_apply(
        p, xx, chunk=cfg.ssm_chunk, dt_act=jm.softplus_act,
        gate_act=jm.silu_act, return_state=True, **_kw(cfg)))(jp, x)
    ty, ts = TSSD.ssd_apply(tp, torch.from_numpy(x), chunk=cfg.ssm_chunk,
                            dt_act=tm.softplus_act, gate_act=tm.silu_act,
                            return_state=True, **_kw(cfg))
    assert ty.shape == x.shape and torch.isfinite(ty).all()
    assert float(np.max(np.abs(ty.numpy() - np.asarray(jy)))) \
        < jm.silu_act.ramp.lsb / 2
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=STATE_ATOL)


def test_ssd_decode_step_matches_jax():
    jm, tm = _acts()
    cfg = jm.cfg
    jp, tp = _block(cfg, seed=2)
    rng = np.random.default_rng(2)
    st = JSSD.ssd_init_state(3, cfg.d_model, conv_width=cfg.conv_width,
                             **_kw(cfg))
    st = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in st.items()}
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    jy, jn = jax.jit(lambda p, xx, ss: JSSD.ssd_decode(
        p, xx, ss, dt_act=jm.softplus_act, gate_act=jm.silu_act,
        **_kw(cfg)))(jp, x, st)
    ty, tn = TSSD.ssd_decode(tp, torch.from_numpy(x),
                             {k: torch.from_numpy(v) for k, v in st.items()},
                             dt_act=tm.softplus_act, gate_act=tm.silu_act,
                             **_kw(cfg))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    for k in ("ssm", "conv"):
        assert tn[k].shape == jn[k].shape and tn[k].dtype == torch.float32
        np.testing.assert_allclose(tn[k].numpy(), np.asarray(jn[k]),
                                   rtol=RTOL, atol=STATE_ATOL, err_msg=k)
    # the conv history is the old one shifted by the new input, exactly
    assert torch.equal(tn["conv"][:, :-1],
                       torch.from_numpy(st["conv"][:, 1:]))


def test_decode_steps_follow_the_full_sequence():
    """20 decode steps from the zero state against ``ssd_apply`` over the
    same 20 inputs (the reference's decode-vs-forward consistency), and
    the carried state against the chunked scan's final state."""
    jm, tm = _acts()
    cfg = jm.cfg
    _, tp = _block(cfg, seed=3)
    s = 20
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32))
    full, final = TSSD.ssd_apply(tp, x, chunk=cfg.ssm_chunk,
                                 dt_act=tm.softplus_act,
                                 gate_act=tm.silu_act, return_state=True,
                                 **_kw(cfg))
    st = TSSD.ssd_init_state(2, cfg.d_model, conv_width=cfg.conv_width,
                             **_kw(cfg))
    outs = []
    for t in range(s):
        y, st = TSSD.ssd_decode(tp, x[:, t:t + 1], st,
                                dt_act=tm.softplus_act, gate_act=tm.silu_act,
                                **_kw(cfg))
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st["ssm"].numpy(), final.numpy(), rtol=RTOL,
                               atol=STATE_ATOL)


def test_init_and_state_layout_match_jax():
    cfg = TC.get_smoke("mamba2-370m")
    jp, _ = _block(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = TSSD.ssd_init(gen, cfg.d_model, conv_width=cfg.conv_width,
                       **_kw(cfg))
    shape = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shape(tp) == shape(jp)
    np.testing.assert_allclose(tp["a_log"].numpy(), np.asarray(jp["a_log"]),
                               rtol=1e-6)
    js = JSSD.ssd_init_state(2, cfg.d_model, conv_width=cfg.conv_width,
                             **_kw(cfg))
    ts = TSSD.ssd_init_state(2, cfg.d_model, conv_width=cfg.conv_width,
                             dtype=torch.bfloat16, **_kw(cfg))
    assert shape(ts) == shape(js)
    assert ts["ssm"].dtype == torch.float32
    assert ts["conv"].dtype == torch.bfloat16
