"""Griffin's RG-LRU block: repro_torch's ``nn/rglru.py`` against the JAX
package's ``repro/nn/rglru.py`` under ``jax.jit``, at the
recurrentgemma-9b SMOKE widths (d 64, lru_width 64), float32,
numpy-seeded inputs and the reference's own init through numpy.

* ``_linear_recurrence`` with ``chunk`` 0 (one scan) and 8 (blocked: a
  scan inside each chunk, one over the chunks' ends);
* ``rglru_apply`` and ``rglru_decode`` with block-diagonal gates (4
  blocks: the batched matmul, then the ``nladc`` sigmoid) and with dense
  gates (the fused ``matmul_nladc``), the NL-ADCs on the ``ref`` backend
  and on the ``cuda`` backend's code on the CPU (its kernel wrappers'
  plain versions), exact ramps and the ``paper-infer`` preset's;
* 16 decode steps against ``rglru_apply`` over the same inputs;
* the init's tree and shapes, and the decode state's.

Tolerances: the port's recurrence is a sequential scan, the reference's
an associative (tree-ordered) one, so the scan is held to rtol 1e-6 /
atol 1e-6 (a few float32 ulps; the decays lie in (0, 1]); the block
outputs to atol 2e-5, within LSB/2 of the gelu ramp (no code flip).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.nn import rglru as JRG
from repro.nn.model import build as jbuild
from repro_torch import configs as TC
from repro_torch.core import backend as TBK
from repro_torch.nn import rglru as TRG
from repro_torch.nn.model import build as tbuild

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

SCAN_TOL = 1e-6
ATOL = 2e-5
KERNELS_ON_CPU = "cuda-on-cpu"
TBK.register_backend(KERNELS_ON_CPU, TBK.CudaBackend("cpu"))


def _models(mode="exact", tbk="ref"):
    """(JAX model, port model) at SMOKE: their gate sigmoid and hidden
    gelu NL-ADCs."""
    spec = dict(enabled=True, adc_bits=5, activation="gelu", mode=mode,
                device="paper-infer" if mode == "infer" else "paper")
    jcfg = JC.get_smoke("recurrentgemma-9b").replace(
        dtype="float32", analog=JSpec(backend="ref", **spec))
    tcfg = TC.get_smoke("recurrentgemma-9b")
    tcfg = tcfg.replace(dtype="float32", analog=dataclasses.replace(
        tcfg.analog, backend=tbk, **spec))
    return jbuild(jcfg), tbuild(tcfg, device="cpu")


def _torch(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _block(cfg, gate_blocks, seed=0):
    jp = JRG.rglru_init(jax.random.PRNGKey(seed), cfg.d_model,
                        cfg.lru_width, cfg.conv_width,
                        gate_blocks=gate_blocks)
    return jp, _torch(jp)


@pytest.mark.parametrize("chunk", [0, 8])
def test_linear_recurrence_matches_jax(chunk):
    rng = np.random.default_rng(chunk)
    a = rng.uniform(0.5, 1.0, (2, 32, 24)).astype(np.float32)
    b = rng.standard_normal((2, 32, 24)).astype(np.float32)
    jh = jax.jit(lambda aa, bb: JRG._linear_recurrence(
        aa, bb, chunk=chunk))(a, b)
    th = TRG._linear_recurrence(torch.from_numpy(a), torch.from_numpy(b),
                                chunk=chunk)
    assert th.shape == a.shape and th.dtype == torch.float32
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=SCAN_TOL,
                               atol=SCAN_TOL)


def test_chunked_recurrence_is_the_plain_scan():
    """Blocking changes the order of the products only: within float32
    rounding of the one-scan result, and the ragged case (S % chunk != 0)
    falls back to it."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 40, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 40, 8)).astype(np.float32))
    plain = TRG._linear_recurrence(a, b)
    np.testing.assert_allclose(TRG._linear_recurrence(a, b, chunk=8).numpy(),
                               plain.numpy(), rtol=SCAN_TOL, atol=SCAN_TOL)
    assert torch.equal(TRG._linear_recurrence(a, b, chunk=16), plain)


GATES = {"block_diagonal": 4, "dense": 0}


@pytest.mark.parametrize("tbk", ["ref", KERNELS_ON_CPU])
@pytest.mark.parametrize("mode", ["exact", "infer"])
@pytest.mark.parametrize("gates", sorted(GATES))
def test_rglru_apply_matches_jax(gates, mode, tbk):
    jm, tm = _models(mode, tbk)
    cfg = jm.cfg
    jp, tp = _block(cfg, GATES[gates])
    assert isinstance(tp["wa"], dict) == (gates == "dense")
    x = np.random.default_rng(1).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    jy = jax.jit(lambda p, xx: JRG.rglru_apply(
        p, xx, jm.sigmoid_act, jm.act))(jp, x)
    ty = TRG.rglru_apply(tp, torch.from_numpy(x), tm.sigmoid_act, tm.act)
    assert ty.shape == x.shape and torch.isfinite(ty).all()
    diff = float(np.max(np.abs(ty.numpy() - np.asarray(jy))))
    assert diff < min(jm.act.ramp.lsb, jm.sigmoid_act.ramp.lsb) / 2
    assert diff <= ATOL, diff


@pytest.mark.parametrize("gates", sorted(GATES))
def test_rglru_decode_step_matches_jax(gates):
    jm, tm = _models()
    cfg = jm.cfg
    jp, tp = _block(cfg, GATES[gates], seed=2)
    rng = np.random.default_rng(2)
    st = JRG.rglru_init_state(3, cfg.lru_width, cfg.conv_width)
    st = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in st.items()}
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    jy, jn = jax.jit(lambda p, xx, ss: JRG.rglru_decode(
        p, xx, ss, jm.sigmoid_act, jm.act))(jp, x, st)
    ty, tn = TRG.rglru_decode(tp, torch.from_numpy(x),
                              {k: torch.from_numpy(v) for k, v in st.items()},
                              tm.sigmoid_act, tm.act)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL)
    for k in ("h", "conv"):
        assert tn[k].shape == jn[k].shape
        np.testing.assert_allclose(tn[k].numpy(), np.asarray(jn[k]),
                                   rtol=SCAN_TOL, atol=SCAN_TOL, err_msg=k)


@pytest.mark.parametrize("gates", sorted(GATES))
def test_decode_steps_follow_the_full_sequence(gates):
    jm, tm = _models()
    cfg = jm.cfg
    _, tp = _block(cfg, GATES[gates], seed=3)
    s = 16
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32))
    full = TRG.rglru_apply(tp, x, tm.sigmoid_act, tm.act)
    st = TRG.rglru_init_state(2, cfg.lru_width, cfg.conv_width)
    outs = []
    for t in range(s):
        y, st = TRG.rglru_decode(tp, x[:, t:t + 1], st, tm.sigmoid_act,
                                 tm.act)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("gates", sorted(GATES))
def test_init_and_state_layout_match_jax(gates):
    cfg = TC.get_smoke("recurrentgemma-9b")
    jp, _ = _block(cfg, GATES[gates])
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = TRG.rglru_init(gen, cfg.d_model, cfg.lru_width, cfg.conv_width,
                        gate_blocks=GATES[gates])
    shape = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shape(tp) == shape(jp)
    np.testing.assert_allclose(tp["lam"].numpy(), np.asarray(jp["lam"]),
                               rtol=1e-6)
    js = JRG.rglru_init_state(2, cfg.lru_width, cfg.conv_width)
    ts = TRG.rglru_init_state(2, cfg.lru_width, cfg.conv_width,
                              dtype=torch.bfloat16)
    assert shape(ts) == shape(js)
    assert ts["h"].dtype == torch.float32
    assert ts["conv"].dtype == torch.bfloat16
