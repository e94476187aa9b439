"""The MoE slice: ``repro_torch.nn.moe`` and the grouped expert-gate kernel
(``kernels.fused_matmul_nladc.moe_fused_matmul``) against the JAX
package's ``repro.nn.moe`` and ``kernels.ops.moe_fused_matmul``, and the
moonshot-v1-16b-a3b and deepseek-moe-16b SMOKE models' decode path with an
int8 KV cache.

* Top-k ties: indices equal to ``jax.lax.top_k`` (lower index first), on
  scores a 5-bit sigmoid NL-ADC forces into ties, through ``router_gates``;
  the sigmoid router's gates bitwise, the softmax router's within two
  float32 ulps (XLA's and PyTorch's ``exp`` differ in the last bit).
* ``dispatch_plan``, ``gather_expert_buffer`` and
  ``combine_expert_buffer``: bitwise equal to the jitted reference, in
  float32 and in bfloat16 (the bfloat16 case with
  ``--xla_allow_excess_precision=false``, in a subprocess): the combine
  adds a token's contributions in the reference's order.
* The plain grouped gate against the Pallas one (interpret mode), and the
  ``ref`` backend's ``moe_matmul_nladc`` against the JAX ``ref`` backend
  in float32: the matmuls sum in another order, so codes are equal except
  where the float64 accumulator lies within the float32 summation bound
  of a crossed threshold (``code_flips``, at most 1%), and values are
  equal wherever the codes are (within one float32 ulp against the Pallas
  kernel's closed-form decode; bitwise after a bfloat16 cast).
* ``decode_step`` logits of both SMOKE models (int8 cache, float32) on the
  ``ref`` backend against JAX ``ref`` (both router kinds), and the
  kernels' semantics (their CPU wrappers) against JAX ``pallas``: within
  LSB/2 of the silu ramp (0.102), as ``test_model_family_parity``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.core import backend as JBK
from repro.core import nladc as JN
from repro.core.analog_layer import AnalogActivation as JAct
from repro.core.analog_layer import AnalogConfig as JACfg
from repro.kernels import ops as JOPS
from repro.nn import moe as JMOE
from repro.nn.model import build as jbuild
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.core import backend as TBK
from repro_torch.core import nladc as TN
from repro_torch.core.analog_layer import AnalogActivation as TAct
from repro_torch.core.analog_layer import AnalogConfig as TACfg
from repro_torch.core.nladc import BankedThresholds
from repro_torch.kernels import flash_decode as TFD
from repro_torch.kernels import fused_matmul_nladc as TFM
from repro_torch.kernels import nladc as TNK
from repro_torch.kernels import prefill_attention as TPA
from repro_torch.kernels.ref import thermometer_count
from repro_torch.nn import moe as TMOE
from repro_torch.nn.model import build as tbuild

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

ROOT = Path(__file__).resolve().parents[1]
MAX_FLIP_SHARE = 0.01
VALUE_RTOL = 2.0 ** -23
STEPS, BATCH, MAX_LEN = 8, 2, 16


def _count_ramp(ramp):
    p = len(ramp.thresholds)
    return dataclasses.replace(ramp, y_table=np.arange(p + 1.0),
                               split_index=-1, monotonic_split=False)


@pytest.mark.parametrize("which", ["get", "get_smoke"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-moe-16b"])
def test_configs_match_jax(arch, which):
    """The MoE configs are the reference's, number for number, in a schema
    that is the reference's field for field."""
    assert [f.name for f in dataclasses.fields(TC.ModelConfig)] == \
        [f.name for f in dataclasses.fields(JC.base.ModelConfig)]
    want = dataclasses.asdict(getattr(JC, which)(arch))
    assert dataclasses.asdict(getattr(TC, which)(arch)) == want
    assert arch in TC.ARCH_NAMES


# -- routing ---------------------------------------------------------------

def test_stable_top_k_breaks_ties_as_jax():
    scores = np.array([[.5, .9, .5, .9, .1, .9, .5],
                       [.2, .2, .2, .2, .2, .2, .2]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(scores), 4)
    tv, ti = TMOE.stable_top_k(torch.tensor(scores), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0].tolist() == [1, 3, 5, 0]


@pytest.mark.parametrize("score,dtype", [("sigmoid", "float32"),
                                         ("sigmoid", "bfloat16"),
                                         ("softmax", "float32")])
def test_router_gates_with_forced_ties(score, dtype):
    """Logits on a coarse grid: the 5-bit sigmoid NL-ADC maps many of the
    64 experts of a token to one level, so the top 6 hold ties."""
    rng = np.random.default_rng(7)
    logits = rng.choice(np.linspace(-3, 3, 9), (5, 64)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    spec = dict(enabled=True, adc_bits=5, input_bits=None, device="ideal")
    jact = JAct("sigmoid", JACfg(backend="ref", **spec))
    tact = TAct("sigmoid", TACfg(backend="ref", **spec))
    jg, ji, _ = JMOE.router_gates(jnp.asarray(logits).astype(jdt), 6,
                                  score, jact)
    tg, ti, _ = TMOE.router_gates(torch.tensor(logits).to(tdt), 6, score,
                                  tact)
    if score == "sigmoid":
        levels = tact(torch.tensor(logits).to(tdt))
        top = TMOE.stable_top_k(levels, 7)[0]
        assert bool((top[:, :-1] == top[:, 1:]).any())   # ties in the top 6
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tg.dtype == tdt
    want = np.asarray(jg.astype(jnp.float32))
    if score == "sigmoid":      # table values, a sum and a division
        np.testing.assert_array_equal(tg.float().numpy(), want)
    else:                       # XLA's and PyTorch's exp differ in the ulp
        np.testing.assert_allclose(tg.numpy(), want, rtol=2 * VALUE_RTOL,
                                   atol=0)


# -- dispatch and combine ----------------------------------------------------

def _dispatch_case(dtype):
    """5 tokens, top-3 of 4 experts, capacity 3 (some slots dropped)."""
    rng = np.random.default_rng(11)
    n, k, e, cap, d = 5, 3, 4, 3, 6
    scores = rng.normal(0, 1, (n, e)).astype(np.float32)
    _, idx = jax.lax.top_k(jnp.asarray(scores), k)
    gates = rng.uniform(0.05, 1, (n, k)).astype(np.float32)
    xf = rng.normal(0, 1, (n, d)).astype(np.float32)
    h = rng.normal(0, 1, (e, cap, d)).astype(np.float32)
    # values of mixed magnitude, so the order of the adds shows in bf16
    h[..., 0] *= 300.0
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    @jax.jit
    def ref(idx, gates, xf, h):
        st, sg, dest, valid = JMOE.dispatch_plan(idx, gates, n, e, cap)
        buf = JMOE.gather_expert_buffer(xf, st, dest, valid, e, cap)
        out = JMOE.combine_expert_buffer(h, xf, st, sg, dest, valid)
        return st, sg, dest, valid, buf, out

    want = ref(idx, jnp.asarray(gates).astype(jdt),
               jnp.asarray(xf).astype(jdt), jnp.asarray(h).astype(jdt))
    ti = torch.tensor(np.asarray(idx)).long()
    tx = torch.tensor(xf).to(tdt)
    st, sg, dest, valid = TMOE.dispatch_plan(ti, torch.tensor(gates).to(tdt),
                                             n, e, cap)
    buf = TMOE.gather_expert_buffer(tx, st, dest, valid, e, cap)
    out = TMOE.combine_expert_buffer(torch.tensor(h).to(tdt), tx, st, sg,
                                     dest, valid)
    got = (st, sg, dest, valid, buf, out)
    assert not bool(valid.all())               # capacity drops a slot
    same = {}
    for name, w, g in zip(("st", "sg", "dest", "valid", "buf", "out"),
                          want, got):
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                       else w)
        same[name] = bool(np.array_equal(g.float().numpy()
                                         if g.is_floating_point()
                                         else g.numpy(), w))
    return same


def test_dispatch_gather_combine_bitwise_f32():
    same = _dispatch_case("float32")
    assert all(same.values()), same


_BF16_SCRIPT = """
import json, sys
sys.path.insert(0, {tests!r})
import test_torch_moe as T
print(json.dumps(T._dispatch_case("bfloat16")))
"""


def _run_excess_precision_off(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_dispatch_gather_combine_bitwise_bf16():
    same = _run_excess_precision_off(
        _BF16_SCRIPT.format(tests=str(ROOT / "tests")))
    assert all(same.values()), same


def test_combine_adds_in_slot_order():
    """One token, three contributions [1, 2**-8, 2**-8] in expert order:
    added one after another in bfloat16 they give 1.0 (each 2**-8 is
    half an ulp of 1 and rounds to even); added smallest first, 1.0078."""
    h = torch.tensor([[[1.0]], [[2.0 ** -8]], [[2.0 ** -8]]],
                     dtype=torch.bfloat16)
    xf = torch.zeros(1, 1, dtype=torch.bfloat16)
    st = torch.zeros(3, dtype=torch.long)
    sg = torch.ones(3, dtype=torch.bfloat16)
    dest = torch.arange(3)
    out = TMOE.combine_expert_buffer(h, xf, st, sg, dest,
                                     torch.ones(3, dtype=torch.bool))
    assert out.item() == 1.0
    out_rev = TMOE.combine_expert_buffer(h.flip(0), xf, st, sg, dest,
                                         torch.ones(3, dtype=torch.bool))
    assert out_rev.item() == 1.0078125


# -- the grouped expert gate -------------------------------------------------

def _gate_case(e, c, d, f, name, dtype, tile_cols, seed):
    rng = np.random.default_rng(seed)
    ramp = JN.build_ramp(name, 5)
    x = rng.normal(0, 1.0, (e, c, d)).astype(np.float32)
    x[0, -1] = 0.0                                   # an empty capacity row
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = rng.normal(0, 2.0 / np.sqrt(d), (e, d, f)).astype(np.float32)
    thr64 = np.asarray(ramp.thresholds, np.float64)
    if tile_cols:
        bm_j = JN.bank_map_for(f, tile_cols)
        banks = (thr64[None, :] + rng.normal(0, 0.03, (bm_j.n_banks, 1))
                 ).astype(np.float32)
        thr_j = JN.BankedThresholds(jnp.asarray(banks), bm_j)
        thr_t = TN.BankedThresholds(torch.from_numpy(banks),
                                    TN.bank_map_for(f, tile_cols))
    else:
        thr_j = jnp.asarray(thr64.astype(np.float32))
        thr_t = torch.from_numpy(thr64.astype(np.float32))
    return ramp, x, w, thr_j, thr_t


GATE_CASES = [(4, 3, 40, 24, "silu", "float32", 0),
              (4, 3, 40, 24, "silu", "bfloat16", 0),
              (3, 5, 64, 80, "sigmoid", "bfloat16", 16)]


@pytest.mark.parametrize("e,c,d,f,name,dtype,tile_cols", GATE_CASES)
def test_plain_grouped_gate_matches_pallas(e, c, d, f, name, dtype,
                                           tile_cols):
    ramp, x, w, thr_j, thr_t = _gate_case(e, c, d, f, name, dtype,
                                          tile_cols, seed=e * 100 + f)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    n_j = torch.from_numpy(np.asarray(JOPS.moe_fused_matmul(
        xj, jnp.asarray(w), _count_ramp(ramp), thresholds=thr_j)
        .astype(jnp.float32)).astype(np.int64))
    y_j = np.asarray(JOPS.moe_fused_matmul(xj, jnp.asarray(w), ramp,
                                           thresholds=thr_j)
                     .astype(jnp.float32))

    xt = torch.tensor(x).to(torch.bfloat16 if dtype == "bfloat16"
                            else torch.float32)
    wt = torch.tensor(w)
    thr = thr_t.per_column if tile_cols else thr_t
    y_table = torch.from_numpy(np.asarray(ramp.y_table, np.float32))
    n0 = TFM.moe_fused_matmul.launches
    y_plain = TFM.moe_fused_matmul_plain(xt, wt, thr, y_table)
    assert torch.equal(TFM.moe_fused_matmul(xt, wt, thr, y_table), y_plain)
    assert TFM.moe_fused_matmul.launches == n0
    assert y_plain.shape == (e, c, f) and y_plain.dtype == xt.dtype
    # over the expert axis: each expert is the dense plain version
    for i in range(e):
        assert torch.equal(y_plain[i], TFM.fused_matmul_nladc_plain(
            xt[i], wt[i], None, thr, y_table))
    n_t = thermometer_count(xt.float() @ wt, thr)
    acc, bound = TFM.accumulator_bound(xt, wt)
    flips, unexplained = TFM.code_flips(n_t, n_j, acc, bound, thr)
    assert unexplained == 0 and flips <= MAX_FLIP_SHARE * n_t.numel()
    same = (n_t == n_j).numpy()
    y_t = y_plain.float().numpy()
    if dtype == "float32":
        tol = VALUE_RTOL * np.maximum(1.0, np.abs(y_j))
        assert np.all(np.abs(y_t - y_j)[same] <= tol[same])
    else:
        assert np.array_equal(y_t[same], y_j[same])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_cols", [0, 16], ids=["flat", "banked"])
def test_empty_expert_is_the_table_at_the_zero_code(tile_cols, dtype):
    """The identity the CUDA expert gate's skip rests on: an expert whose
    capacity rows all compare equal to 0 (+0.0 or -0.0, as the dispatch's
    ``x * 0`` leaves them) gives ``y_table[#{j : 0 > thr_j}]`` in every
    output, per column for banked thresholds.  The plain version gives it
    bitwise, and the Pallas gate (interpret mode) gives the same codes
    bitwise; its values are its closed-form decode at those codes, equal
    to the table's (within one float32 ulp; bitwise in bfloat16), as in
    ``test_plain_grouped_gate_matches_pallas``.  Experts with live rows
    beside them are unaffected."""
    ramp, x, w, thr_j, thr_t = _gate_case(4, 3, 64, 48, "silu", dtype,
                                          tile_cols, seed=11 + tile_cols)
    x = x.copy()
    x[1] = -0.0                                   # every row -0.0
    x[2] = 0.0
    x[2, :, ::3] = -0.0                           # +0.0 and -0.0 mixed
    x[3, 1:] = -0.0                               # one live row among zeros
    assert np.signbit(x[1]).all() and np.signbit(x[2]).any()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    n_j = torch.from_numpy(np.asarray(JOPS.moe_fused_matmul(
        xj, jnp.asarray(w), _count_ramp(ramp), thresholds=thr_j)
        .astype(jnp.float32)).astype(np.int64))
    y_j = np.asarray(JOPS.moe_fused_matmul(xj, jnp.asarray(w), ramp,
                                           thresholds=thr_j)
                     .astype(jnp.float32))

    xt = torch.tensor(x).to(torch.bfloat16 if dtype == "bfloat16"
                            else torch.float32)
    assert torch.signbit(xt[1]).all()             # -0.0 survives the cast
    wt = torch.tensor(w)
    thr = thr_t.per_column if tile_cols else thr_t
    y_table = torch.from_numpy(np.asarray(ramp.y_table, np.float32))
    y_plain = TFM.moe_fused_matmul_plain(xt, wt, thr, y_table)
    zero = thermometer_count(torch.zeros(w.shape[-1]), thr)   # (f,)
    want = y_table[zero].to(xt.dtype).expand(3, -1)
    for e, rows in ((1, slice(None)), (2, slice(None)), (3, slice(1, None))):
        assert torch.equal(y_plain[e, rows], want[rows])
        assert torch.equal(n_j[e, rows], zero.expand(3, -1)[rows])
        y_e = torch.from_numpy(y_j[e, rows].copy())
        if dtype == "float32":
            tol = VALUE_RTOL * torch.clamp_min(y_e.abs(), 1.0)
            assert bool(((y_plain[e, rows].float() - y_e).abs()
                         <= tol).all())
        else:
            assert torch.equal(y_plain[e, rows].float(), y_e)
    # the live rows are the dense plain version's
    assert torch.equal(y_plain[0], TFM.fused_matmul_nladc_plain(
        xt[0], wt[0], None, thr, y_table))
    assert torch.equal(y_plain[3, :1], TFM.fused_matmul_nladc_plain(
        xt[3, :1], wt[3], None, thr, y_table))


@pytest.mark.parametrize("tile_cols", [0, 16])
def test_ref_moe_matmul_nladc_matches_jax_ref(tile_cols):
    ramp, x, w, thr_j, thr_t = _gate_case(4, 3, 40, 48, "silu", "float32",
                                          tile_cols, seed=5 + tile_cols)
    jref, tref = JBK.get_backend("ref"), TBK.get_backend("ref")
    cramp = _count_ramp(ramp)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    n_j = np.asarray(jref.moe_matmul_nladc(xj, wj, JN.NLADC(cramp), thr_j))
    y_j = np.asarray(jref.moe_matmul_nladc(xj, wj, JN.NLADC(ramp), thr_j))
    xt, wt = torch.tensor(x), torch.tensor(w)
    n_t = tref.moe_matmul_nladc(xt, wt, TN.NLADC(cramp), thr_t).long()
    y_t = tref.moe_matmul_nladc(xt, wt, TN.NLADC(ramp), thr_t).numpy()
    thr = thr_t.per_column if tile_cols else thr_t
    acc, bound = TFM.accumulator_bound(xt, wt)
    flips, unexplained = TFM.code_flips(
        n_t, torch.from_numpy(n_j.astype(np.int64)), acc, bound, thr)
    assert unexplained == 0 and flips <= MAX_FLIP_SHARE * n_t.numel()
    same = n_t.numpy() == n_j
    np.testing.assert_array_equal(y_t[same], y_j[same])


# -- the models --------------------------------------------------------------

class _KernelsOnCPU(TBK.RefBackend):
    """The ``cuda`` backend's functions through the kernels' CPU wrappers
    (their plain versions), for tensors on the CPU."""

    name = "moe-kernels-cpu"

    @staticmethod
    def _thr(adc, thresholds):
        thr = adc.thresholds if thresholds is None else thresholds
        return thr.per_column if isinstance(thr, BankedThresholds) else thr

    def nladc(self, x, adc, thresholds=None):
        return TNK.nladc(x.contiguous(), self._thr(adc, thresholds),
                         adc.y_table)

    def matmul_nladc(self, x, w, adc, bias=None, thresholds=None):
        y = TFM.fused_matmul_nladc(x.reshape(-1, x.shape[-1]), w, bias,
                                   self._thr(adc, thresholds), adc.y_table)
        return y.reshape(x.shape[:-1] + (w.shape[-1],))

    def moe_matmul_nladc(self, x, w, adc, thresholds=None):
        return TFM.moe_fused_matmul(x.contiguous(), w,
                                    self._thr(adc, thresholds), adc.y_table)

    def prefill_attention(self, q, k, v, mask):
        m = torch.broadcast_to(mask, (q.shape[0], 1, k.shape[1]))[:, 0]
        return TPA.prefill_attention(q[:, 0].contiguous(), k, v,
                                     m.to(torch.int32))[:, None]

    def decode_attention_int8(self, q, k8, k_scale, v8, v_scale, length):
        return TFD.flash_decode_int8(q.contiguous(), k8, k_scale, v8,
                                     v_scale, length)


TBK.register_backend(_KernelsOnCPU.name, _KernelsOnCPU())


def _models(arch, jbk, tbk, kv="int8", seed=0):
    jcfg = JC.get_smoke(arch).replace(
        dtype="float32", kv_cache_dtype=kv,
        analog=JSpec(enabled=True, adc_bits=5, activation="silu",
                     backend=jbk))
    tcfg = TC.get_smoke(arch)
    tcfg = tcfg.replace(dtype="float32", kv_cache_dtype=kv,
                        analog=dataclasses.replace(tcfg.analog, backend=tbk))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = tbuild(tcfg, device="cpu")
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def _decode_diff(jm, jp, tm, tp, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, jm.cfg.vocab, (STEPS, BATCH)).astype(np.int32)
    js = jm.init_decode_state(BATCH, MAX_LEN)
    ts = tm.init_decode_state(BATCH, MAX_LEN)
    step = jax.jit(jm.decode_step)
    worst = 0.0
    for t in range(STEPS):
        jl, js = step(jp, js, jnp.asarray(toks[t][:, None]))
        tl, ts = tm.decode_step(
            tp, ts, torch.as_tensor(toks[t][:, None].astype(np.int64)))
        assert tl.shape == (BATCH, 1, tm.cfg.padded_vocab)
        assert torch.isfinite(tl).all()
        worst = max(worst, float(np.max(np.abs(np.asarray(jl)
                                               - tl.numpy()))))
    for lj, lt in zip(range(tm.cfg.n_layers), ts["layers"]):
        for name in ("k", "v", "k_scale", "v_scale"):
            assert lt[name].dtype == (torch.int8 if len(name) == 1
                                      else torch.bfloat16)
    return worst


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-moe-16b"])
def test_smoke_decode_ref_matches_jax_ref(arch):
    jm, jp, tm, tp = _models(arch, "ref", "ref")
    assert tm.layer_kinds() == ("moe_attn",) * tm.cfg.n_layers
    assert _decode_diff(jm, jp, tm, tp) < jm.act.ramp.lsb / 2


def test_smoke_decode_kernel_semantics_match_jax_pallas():
    jm, jp, tm, tp = _models("moonshot-v1-16b-a3b", "pallas",
                             _KernelsOnCPU.name)
    assert _decode_diff(jm, jp, tm, tp) < jm.act.ramp.lsb / 2


def test_moe_params_convert_and_init_layout():
    """``lm_params_from_jax`` splits the stacked (L, E, d, f) experts, the
    router and the shared experts per layer; the port's seeded init has
    the same layout."""
    jm, jp, tm, tp = _models("moonshot-v1-16b-a3b", "ref", "ref")
    gen = torch.Generator()
    gen.manual_seed(0)
    fresh = tm.init(gen)
    for layers in (tp["layers"], fresh["layers"]):
        assert len(layers) == tm.cfg.n_layers
        for i, layer in enumerate(layers):
            shapes = jax.tree_util.tree_map(lambda a: a.shape[1:],
                                            jp["layers"])
            assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                          layer) == shapes
    np.testing.assert_array_equal(tp["layers"][1]["moe"]["w_gate"].numpy(),
                                  np.asarray(jp["layers"]["moe"]["w_gate"][1]))
    assert "lm_head" in tp and "lm_head" in fresh     # untied
