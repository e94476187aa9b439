"""The recurrent LM families: repro_torch's ``LM`` and ``ServingEngine``
for mamba2-370m (``ssm``: SSD blocks) and recurrentgemma-9b (``hybrid``:
(rec, rec, attn) groups of RG-LRU and local attention, a rolling-window
KV cache) against the JAX package's, at the SMOKE widths (mamba2: 2
layers, d 64, 8 heads of 16, state 16, chunk 16; recurrentgemma: 3
layers, d 64, lru_width 64, 4 heads over 1 KV head of 16, d_ff 128,
window 8), float32, the same weights through ``lm_params_from_jax`` and
numpy-seeded tokens.

* ``LM.forward`` (B 2 x S 12) and ``decode_step`` (12 steps) in exact
  and infer mode (the ``paper-infer`` preset's programmed ramps and
  banks), flat thresholds and 16-column banks, ``ref`` against ``ref``;
* the kernels' semantics: the ``cuda`` backend's code on the CPU (its
  kernel wrappers' plain versions) against the JAX ``pallas`` backend in
  interpret mode, the per-arch twin of the reference's
  ``test_model_family_parity``;
* the rolling-window cache decoded to 3x the window, with a
  compute-dtype and an int8 KV cache (the dequantize-all fallback),
  against the reference step by step, and the last step against the
  port's own windowed full-sequence forward;
* the init's tree against ``LM.init``'s, and an ``.npz`` round trip of
  the hybrid's ``groups`` and ``tail``;
* at recurrentgemma's full widths, the hidden gelu and the gate sigmoid
  NL-ADCs' thresholds at 4096 (the ``W_g`` branch, the gates) and 12288
  (the MLP gate), flat and in 512-column banks, bitwise the reference's;
* the serving engine by scan, bucketed, packed and chunked prefill: the
  streams equal the JAX scan engine's; the unpacked bucketed state is
  bitwise the port's scan state; packed, the recurrent leaves (``ssm``,
  ``conv``, ``h``) are within atol 1e-6 of it (the reference's own
  ``test_bucketed_parity_recurrent_arch`` holds its packed SSM wave so;
  measured 1.5e-8) and the hybrid's KV cache within atol 1e-5, the
  dense family's packed contract (``tests/test_torch_serve_bucketed.py``:
  the projections see P rows at once; measured 1.4e-6);
* weights aged by ``device=`` bitwise the reference engine's (mamba2's
  ``layers``, the hybrid's ``groups`` and ``tail``); mamba2's deployment
  checkpoint against the reference's and resumed bitwise; the hybrid's
  checkpoint, lifecycle and fleet run (held to the reference in
  ``tests/test_torch_recurrent_{lifecycle,ckpt,fleet}.py``).

Logit criterion, as ``tests/test_torch_lm_forward.py``'s: max |delta| <
LSB/2 of the hidden ramp (0.102 for silu, 0.068 for gelu); measured below
2e-6 at seed 0 in every case (no code flip).  Decode against forward:
relative error < 1e-3, the reference's ``test_decode_consistency``.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.core.analog_layer import AnalogActivation as JAct
from repro.core.analog_layer import AnalogConfig as JCfg
from repro.core.device import get_device as jget_device
from repro.nn.mlp import make_activation as jmake_activation
from repro.nn.model import build as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import convert
from repro_torch.core import backend as TBK
from repro_torch.core.analog_layer import AnalogActivation as TAct
from repro_torch.core.analog_layer import AnalogConfig as TCfg
from repro_torch.core.device import get_device as tget_device
from repro_torch.launch import serve as TSERVE
from repro_torch.nn.mlp import make_activation as tmake_activation
from repro_torch.nn.model import build as tbuild
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.fleet import FleetEngine
from repro_torch.serve.lifecycle import RecalPolicy
from repro_torch.train.optim import tree_leaves

ARCHS = ("mamba2-370m", "recurrentgemma-9b")
ACT = {"mamba2-370m": "silu", "recurrentgemma-9b": "gelu"}
BANK_COLS = 16
B, S = 2, 12
DECODE_REL = 1e-3
INT8_REL = 5e-2     # an int8 cache against the float forward
PACKED_ATOL = 1e-6
PACKED_KV_ATOL = 1e-5
KERNELS_ON_CPU = "cuda-on-cpu"
TBK.register_backend(KERNELS_ON_CPU, TBK.CudaBackend("cpu"))


@functools.lru_cache(maxsize=None)
def models(arch, mode="exact", bank_cols=0, jbk="ref", tbk="ref",
           overrides=()):
    """(JAX model, JAX params, port model, port params) on one config;
    ``overrides``: config fields as a tuple of pairs."""
    spec = dict(enabled=True, adc_bits=5, activation=ACT[arch], mode=mode,
                device="paper-infer" if mode == "infer" else "paper",
                bank_cols=bank_cols)
    kw = dict(overrides)
    jcfg = JC.get_smoke(arch).replace(dtype="float32",
                                      analog=JSpec(backend=jbk, **spec), **kw)
    tcfg = TSERVE.make_config(arch, smoke=True, backend=tbk,
                              overrides=kw).replace(dtype="float32")
    tcfg = tcfg.replace(analog=dataclasses.replace(tcfg.analog, **spec))
    jm = jbuild(jcfg)
    _realize_banks(jm)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tcfg, device="cpu")
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def _realize_banks(jm):
    """Realize the reference's threshold banks at every width its blocks
    apply an NL-ADC to, before any trace: a bank first realized inside
    ``jax.jit`` keeps a tracer (the reference realizes only ``d_ff``
    eagerly), and the next trace fails on it."""
    cfg = jm.cfg
    widths = {cfg.d_ff, cfg.lru_width, cfg.ssm_expand * cfg.d_model,
              cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim}
    for act in (jm.act, jm.sigmoid_act, jm.softplus_act, jm.silu_act):
        for w in widths:
            act.bank_for(w)


def _tokens(cfg, s=S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, s)).astype(np.int32)


def _forward_diff(jm, jp, tm, tp):
    toks = _tokens(jm.cfg)
    jl = jax.jit(jm.forward)(jp, toks)
    tl = tm.forward(tp, torch.from_numpy(toks).long())
    assert tl.shape == (B, S, tm.cfg.padded_vocab)
    assert tl.dtype == torch.float32 and torch.isfinite(tl).all()
    return float(np.max(np.abs(np.asarray(jl) - tl.numpy())))


def _decode_diff(jm, jp, tm, tp, steps=S, max_len=16):
    toks = _tokens(jm.cfg, steps)
    js = jm.init_decode_state(B, max_len)
    ts = tm.init_decode_state(B, max_len)
    step = jax.jit(jm.decode_step)
    worst = 0.0
    for t in range(steps):
        jl, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        tl, ts = tm.decode_step(tp, ts, torch.from_numpy(
            toks[:, t:t + 1]).long())
        assert torch.isfinite(tl).all()
        worst = max(worst, float(np.max(np.abs(np.asarray(jl)
                                               - tl.numpy()))))
    assert ts["index"] == steps == int(js["index"])
    return worst, ts


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("mode", ["exact", "infer"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, mode, banked):
    jm, jp, tm, tp = models(arch, mode, BANK_COLS if banked else 0)
    assert tm.act.n_banks(tm.cfg.d_ff or 1) == (
        (tm.cfg.d_ff + BANK_COLS - 1) // BANK_COLS
        if banked and tm.cfg.d_ff else 1)
    assert _forward_diff(jm, jp, tm, tp) < jm.act.ramp.lsb / 2


@pytest.mark.parametrize("banked", [False, True])
@pytest.mark.parametrize("mode", ["exact", "infer"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch, mode, banked):
    jm, jp, tm, tp = models(arch, mode, BANK_COLS if banked else 0)
    worst, _ = _decode_diff(jm, jp, tm, tp)
    assert worst < jm.act.ramp.lsb / 2


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_semantics_match_jax_pallas(arch):
    """``cuda``'s code on the CPU against JAX ``pallas`` (interpret mode):
    the full sequence and the decode path."""
    jm, jp, tm, tp = models(arch, "exact", jbk="pallas", tbk=KERNELS_ON_CPU)
    assert _forward_diff(jm, jp, tm, tp) < jm.act.ramp.lsb / 2
    worst, _ = _decode_diff(jm, jp, tm, tp, steps=4)
    assert worst < jm.act.ramp.lsb / 2


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Decode step by step against the full-sequence forward (the
    reference's ``test_decode_matches_forward``), and ``prefill``'s last
    position against the last decode step."""
    _, _, tm, tp = models(arch)
    toks = torch.from_numpy(_tokens(tm.cfg)).long()
    full = tm.forward(tp, toks)
    st = tm.init_decode_state(B, 32)
    outs = []
    for t in range(S):
        logits, st = tm.decode_step(tp, st, toks[:, t:t + 1])
        outs.append(logits[:, 0])
    dec = torch.stack(outs, 1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < DECODE_REL, rel
    last = tm.prefill(tp, toks)
    assert last.shape == (B, 1, tm.cfg.padded_vocab)
    assert float((last[:, 0] - dec[:, -1]).abs().max()
                 / dec[:, -1].abs().max()) < DECODE_REL


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_rolling_cache_past_the_window(kv):
    """recurrentgemma's local attention decoded to 3x its window (8): the
    cache keeps ``window`` slots, every step within LSB/2 of the
    reference's (its int8 fallback dequantizes every slot), and the last
    step within the decode criterion of the windowed full-sequence
    forward (5e-2 for the int8 cache, whose codes round K and V to 1/254
    of their row's range: the reference's ``test_int8_kv_cache_close_to_
    bf16`` bound; float32 compute: the bf16 setting names the
    compute-dtype cache)."""
    arch = "recurrentgemma-9b"
    jm, jp, tm, tp = models(arch, overrides=(("kv_cache_dtype", kv),))
    window = tm.cfg.window
    s = 3 * window
    worst, ts = _decode_diff(jm, jp, tm, tp, steps=s, max_len=s)
    assert worst < jm.act.ramp.lsb / 2
    attn = ts["groups"][0]["b2_attn"]
    assert attn["k"].shape[1] == window
    assert attn["k"].dtype == (torch.int8 if kv == "int8"
                               else torch.float32)
    toks = torch.from_numpy(_tokens(tm.cfg, s)).long()
    full = tm.forward(tp, toks)
    st = tm.init_decode_state(B, s)
    for t in range(s):
        logits, st = tm.decode_step(tp, st, toks[:, t:t + 1])
    rel = float((logits[:, 0] - full[:, -1]).abs().max()
                / full[:, -1].abs().max())
    assert rel < (DECODE_REL if kv == "bfloat16" else INT8_REL), rel


@pytest.mark.parametrize("bank_cols", [0, 512])
def test_hidden_banks_at_the_wg_width_are_the_references(bank_cols):
    """recurrentgemma-9b's hidden gelu NL-ADC digitizes the MLP gate (width
    d_ff 12288) and the RG-LRU ``W_g`` branch (width 4096); the gate
    sigmoid the block-diagonal gates (4096).  At full width, infer mode on
    ``paper-infer``: every threshold set the port realizes, flat and in
    512-column banks (24 and 8 banks, the per-bank draws keyed by index),
    is bitwise the reference's."""
    spec = dict(enabled=True, adc_bits=5, activation="gelu", mode="infer",
                device="paper-infer", bank_cols=bank_cols)
    jcfg = JC.get("recurrentgemma-9b").replace(analog=JSpec(**spec))
    tcfg = TSERVE.make_config("recurrentgemma-9b", backend="ref")
    tcfg = tcfg.replace(analog=dataclasses.replace(tcfg.analog, **spec))
    pairs = [(jmake_activation(jcfg), tmake_activation(tcfg, "cpu")),
             (JAct("sigmoid", JCfg.from_spec(jcfg.analog)),
              TAct("sigmoid", TCfg.from_spec(tcfg.analog), "cpu"))]
    for jact, tact in pairs:
        for width in (jcfg.lru_width, jcfg.d_ff):
            want = jact.thresholds_for(width=width)
            got = tact.thresholds_for(width)
            banked = bank_cols > 0
            assert hasattr(got, "thr") == hasattr(want, "thr") == banked
            if banked:
                assert got.n_banks == width // bank_cols == want.n_banks
                got, want = got.thr, want.thr
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want, np.float32))


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_matches_jax(arch):
    """The port's seeded init has ``LM.init``'s tree: ``layers`` per
    layer, or ``groups`` per group (the reference stacks them) and the
    ``tail`` list."""
    overrides = (("n_layers", 5),) if arch == "recurrentgemma-9b" else ()
    jm, jp, tm, _ = models(arch, overrides=overrides)
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tm.init(gen)
    assert sorted(tp) == sorted(jp)
    for key in ("layers", "groups"):
        if key in jp:
            want = jax.tree_util.tree_map(lambda a: a.shape[1:], jp[key])
            assert len(tp[key]) == len(jax.tree_util.tree_leaves(
                jp[key])[0])
            assert all(_shapes(t) == want for t in tp[key])
    if "tail" in jp:
        assert len(tp["tail"]) == 2 == len(jp["tail"])
        assert _shapes(tp["tail"]) == _shapes(jp["tail"])
    assert tp["embed"]["table"].shape == jp["embed"]["table"].shape
    assert ("lm_head" in tp) == (not tm.cfg.tie_embeddings)
    kinds = [k for k, _ in tm.blocks(tp)]
    assert tuple(kinds) == tuple(jm.layer_kinds())


def test_hybrid_params_roundtrip_through_npz(tmp_path):
    _, jp, tm, tp = models("recurrentgemma-9b",
                           overrides=(("n_layers", 5),))
    path = tmp_path / "lm.npz"
    convert.save_npz(path, jax.tree_util.tree_map(np.asarray, jp))
    back = convert.load_npz(path)
    assert len(back["groups"]) == 1 and len(back["tail"]) == 2
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert torch.equal(a, b)


# -- the serving engine ------------------------------------------------------

PROMPTS = [np.arange(1, 6, dtype=np.int32),        # short
           np.arange(2, 15, dtype=np.int32),       # past the window
           np.asarray([7], np.int32),              # no prefill
           np.arange(3, 25, dtype=np.int32)]       # long: chunked twice
MAX_BATCH, MAX_LEN, MAX_NEW = 2, 48, 6
ENGINE_MODES = {"scan": {}, "bucketed": dict(prefill="bucketed"),
                "packed": dict(prefill="bucketed", pack_prefill=True),
                "chunked": dict(prefill="bucketed", pack_prefill=True,
                                prefill_buckets=(4, 8))}


def _serve(engine_cls, request_cls, model, params, **kw):
    eng = engine_cls(model, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                     **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [list(r.generated) for r in reqs], eng


@functools.lru_cache(maxsize=None)
def _jax_scan_streams(arch):
    jm, jp, _, _ = models(arch)
    return _serve(JEngine, JRequest, jm, jp)[0]


@functools.lru_cache(maxsize=None)
def _port_scan(arch):
    _, _, tm, tp = models(arch)
    return _serve(ServingEngine, Request, tm, tp)


def _state_leaves(model, eng):
    return [t for _, blk in model.blocks(eng.state)
            for _, t in sorted(blk.items())]


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_jax(arch, mode):
    _, _, tm, tp = models(arch)
    want = _jax_scan_streams(arch)
    assert all(len(s) == MAX_NEW for s in want)
    scan_streams, scan = _port_scan(arch)
    got, eng = (scan_streams, scan) if mode == "scan" else \
        _serve(ServingEngine, Request, tm, tp, **ENGINE_MODES[mode])
    assert got == want
    if mode == "scan":
        return
    assert eng.state["index"] == scan.state["index"]
    for (kind, a), (_, b) in zip(tm.blocks(scan.state),
                                 tm.blocks(eng.state)):
        for name in a:
            diff = float((a[name].double() - b[name].double()).abs().max())
            if mode == "bucketed":
                assert diff == 0.0, (kind, name, diff)
            else:
                tol = PACKED_KV_ATOL if kind == "attn" else PACKED_ATOL
                assert diff <= tol, (kind, name, diff)
    if mode == "chunked":
        assert 8 in eng.buckets_called and 4 in eng.buckets_called


# -- a deployment ------------------------------------------------------------

PRESET = "aged-1day"
AGED = {"mamba2-370m": (), "recurrentgemma-9b": (("n_layers", 5),)}


@pytest.mark.parametrize("arch", ARCHS)
def test_aged_params_are_bitwise_the_reference_engines(arch):
    """``device=`` ages the served weights per crossbar tile as the
    reference engine ages its stacked params: mamba2's ``layers``, the
    hybrid's ``groups`` (a 3-D gate block stack per group among them) and
    its ``tail`` (2 blocks at 5 layers); then both engines' streams."""
    jm, jp, tm, tp = models(arch, "infer", overrides=AGED[arch])
    je = JEngine(jm, jp, max_batch=MAX_BATCH, max_len=MAX_LEN,
                 device=jget_device(PRESET))
    te = ServingEngine(tm, tp, max_batch=MAX_BATCH, max_len=MAX_LEN,
                       device=tget_device(PRESET))
    want = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, je.params))
    got_l, want_l, pristine = (tree_leaves(te.params), tree_leaves(want),
                               tree_leaves(tp))
    assert len(got_l) == len(want_l) == len(pristine)
    for a, b in zip(got_l, want_l):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert sum(not torch.equal(a, p) for a, p in zip(got_l, pristine)) > \
        len(got_l) // 2
    streams = {}
    for name, eng, req in (("jax", je, JRequest), ("port", te, Request)):
        reqs = [req(uid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(PROMPTS[:2])]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        streams[name] = [list(r.generated) for r in reqs]
    assert streams["port"] == streams["jax"]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def test_ssm_checkpoint_is_the_references_and_resumes(tmp_path):
    """mamba2's deployment checkpoint against the reference engine's at
    the same point of the same run: the same leaf paths and dtypes (the
    ``ssm`` and ``conv`` states stacked per layer), and every leaf but the
    decode state and the noise key bit for bit; the port's restore
    resumes the uninterrupted run bitwise."""
    jm, jp, tm, tp = models("mamba2-370m", "infer")
    dev = tget_device(PRESET)
    je = JEngine(jm, jp, max_batch=MAX_BATCH, max_len=MAX_LEN,
                 device=jget_device(PRESET))

    def fresh():
        eng = ServingEngine(tm, tp, max_batch=MAX_BATCH, max_len=MAX_LEN,
                            device=dev)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW)
                for i, p in enumerate(PROMPTS)]
        for r in reqs:
            eng.submit(r)
        return eng, reqs

    te, _ = fresh()
    for r in [JRequest(uid=i, prompt=p, max_new_tokens=MAX_NEW)
              for i, p in enumerate(PROMPTS)]:
        je.submit(r)
    for _ in range(3):
        je.step()
        te.step()
    je.save(str(tmp_path / "j"), 3)
    root = te.save(str(tmp_path / "t"), 3)

    def manifest(sub):
        with open(tmp_path / sub / "step_00000003" / "manifest.json") as f:
            return json.load(f)

    mj, mt = manifest("j"), manifest("t")
    assert mt["paths"] == mj["paths"] and mt["dtypes"] == mj["dtypes"]
    assert "['state']['layers']['ssm']" in mt["paths"]
    for p in mt["paths"]:
        if p.startswith(("['state']", "['noise_key']")):
            continue
        a = np.load(tmp_path / "t" / "step_00000003" /
                    f"leaf_{mt['paths'].index(p):05d}.npy")
        b = np.load(tmp_path / "j" / "step_00000003" /
                    f"leaf_{mj['paths'].index(p):05d}.npy")
        assert a.dtype == b.dtype and np.array_equal(a, b), p
    ref_eng, ref_reqs = fresh()
    ref_eng.run_to_completion()
    res = ServingEngine.restore(tm, str(tmp_path / "t"),
                                params_like=_clone(tp))
    assert root.endswith("step_00000003")
    restored = {r.uid: r for r in list(res.slot_req) + res.queue
                if r is not None}
    res.run_to_completion()
    for uid, r in restored.items():
        assert r.generated == ref_reqs[uid].generated, uid
    assert all(torch.equal(a, b) for a, b in zip(
        _state_leaves(tm, ref_eng), _state_leaves(tm, res)))


@pytest.mark.parametrize("what", ["save", "restore", "recal", "fleet"])
def test_hybrid_deployment_features_raise(tmp_path, what):
    """The hybrid's deployment features, which raised until they were
    ported, now run (held to the reference in
    ``tests/test_torch_recurrent_{lifecycle,ckpt,fleet}.py``): its
    checkpoint in the reference's layout (``groups`` stacked, ``tail`` by
    index) and the restore of it, an engine with a re-calibration
    scheduler, and a fleet of two chips."""
    _, _, tm, tp = models("recurrentgemma-9b", "infer",
                          overrides=AGED["recurrentgemma-9b"])
    reqs = [Request(uid=i, prompt=p, max_new_tokens=3)
            for i, p in enumerate(PROMPTS[:2])]
    if what in ("save", "restore"):
        eng = ServingEngine(tm, tp, max_batch=2, max_len=16)
        for r in reqs:
            eng.submit(r)
        eng.step()
        root = eng.save(str(tmp_path), 1)
        with open(f"{root}/manifest.json") as f:
            paths = json.load(f)["paths"]
        assert "['state']['groups']['b2_attn']['k']" in paths
        assert "['params']['tail'][1]['rec']['lam']" in paths
        if what == "restore":
            eng.run_to_completion()
            res = ServingEngine.restore(tm, str(tmp_path),
                                        params_like=_clone(tp))
            live = [r for r in res.slot_req if r is not None]
            res.run_to_completion()
            assert [r.generated for r in live] == \
                [reqs[r.uid].generated for r in live]
    elif what == "recal":
        eng = ServingEngine(tm, tp, max_batch=2, max_len=16,
                            device=tget_device(PRESET),
                            recal=RecalPolicy(age_per_step_s=3600.0,
                                              check_every=1))
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        assert eng.scheduler.events and eng.scheduler.age_s > 0
    else:
        fleet = FleetEngine.build(tm.cfg, 2, max_batch=1, max_len=16,
                                  params=tp, torch_device="cpu")
        for r in reqs:
            fleet.submit(r)
        fleet.run_to_completion()
        assert all(len(r.generated) == 3 for r in reqs)
