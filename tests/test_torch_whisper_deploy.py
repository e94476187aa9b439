"""whisper-base deployed: the aged chip, its lifecycle and the weight
refresh against the JAX package's engine.

repro_torch's ``ServingEngine(device=, recal=, drain_before_rejit=,
external_maintenance=)`` and the JAX package's for the encoder-decoder at
SMOKE widths (2 + 2 layers, d_ff 128), float32, ``ref`` backend,
``aged-1day``, 32-column threshold banks (the one gelu ``act`` ramp that
the encoder's and the decoder's MLPs share, banked at d_ff), the same
weights (``convert.encdec_params_from_jax``), served on text with cross
K/V of zeros, as the reference's engine serves it:

* ``DeviceModel.age_params(stacked=("enc_layers", "dec_layers"))`` is the
  reference's ``age_params`` of its stacked tree, leaf for leaf: each
  stack's 1-D leaves (LayerNorm scales and biases, the Q/K/V biases) aged
  as ``(n_layers, N)`` matrices, ``pos_dec`` and the embedding as
  top-level matrices, the final LayerNorms not at all;
* token streams on the aged chip, on the scan and the packed prefill;
* threshold-only re-calibration, at once, after a drain and through a
  maintenance window: streams, the scheduler's events and state, the
  deployed and served thresholds, params and counters bitwise;
* a weight refresh re-programs the whole chip (``EncDecLM`` maps no
  activation to param leaves, as the reference's does not): the
  generation moves and every crossbar of both stacks is re-aged, bitwise
  the reference's.

The checkpoint, the fleet and the launcher are in
``tests/test_torch_whisper_fleet.py``.
"""

import functools
import json

import jax
import numpy as np
import pytest

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.core.device import get_device as jget_device
from repro.nn.model import build as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.lifecycle import RecalPolicy as JPolicy
from repro_torch import convert
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.core.device import get_device as tget_device
from repro_torch.launch import serve as TSERVE
from repro_torch.nn.encdec import EncDecLM
from repro_torch.nn.model import build as tbuild
from repro_torch.serve.engine import (Request, ServingEngine, _stack_state,
                                      _stacked_keys)
from repro_torch.serve.lifecycle import RecalPolicy
from repro_torch.train.optim import tree_leaves
from test_torch_serve_lifecycle import _leaf_paths, _no_wall, _thresholds

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

ARCH = "whisper-base"
PRESET = "aged-1day"
BANK_COLS = 32
STACKS = ("enc_layers", "dec_layers")
# 5, 9, 1 and 12 tokens: a prompt with no prefill, one past the smallest
# bucket
PROMPTS = [np.arange(1, 6, dtype=np.int32), np.arange(2, 11, dtype=np.int32),
           np.asarray([7], np.int32), np.arange(3, 15, dtype=np.int32)]
POLICY = dict(age_per_step_s=3600.0, check_every=2, inl_threshold_lsb=0.4)
CACHE_ATOL = 1e-5        # two packages' float32 matmuls
SIDES = {"jax": (JEngine, JRequest, JPolicy, jget_device),
         "torch": (ServingEngine, Request, RecalPolicy, tget_device)}


@functools.lru_cache(maxsize=None)
def models():
    """(jax model, jax params, port model, port params), built once; the
    gelu bank at d_ff realized on both sides (the reference's first use
    inside ``jax.jit`` would keep a tracer)."""
    analog = dict(enabled=True, mode="infer", device=PRESET, backend="ref",
                  bank_cols=BANK_COLS)
    jcfg = JC.get_smoke(ARCH).replace(dtype="float32", analog=JSpec(**analog))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = TSERVE.make_config(
        ARCH, smoke=True, backend="ref", analog_mode="infer",
        analog_device=PRESET, bank_cols=BANK_COLS).replace(dtype="float32")
    tm = tbuild(tcfg, device="cpu")
    tp = convert.encdec_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))
    for m in (jm, tm):
        m.act.bank_for(m.cfg.d_ff)
    return jm, jp, tm, tp


def engine(side, policy=POLICY, **kw):
    """An engine of ``side`` on the aged chip; ``policy=None``: no
    scheduler."""
    jm, jp, tm, tp = models()
    E, _, P, get = SIDES[side]
    model, params = (jm, jp) if side == "jax" else (tm, tp)
    recal = None if policy is None else P(**policy)
    return E(model, params, max_batch=2, max_len=48, device=get(PRESET),
             recal=recal, **kw)


def requests(side, prompts=PROMPTS, max_new=6, uid0=0):
    R = SIDES[side][1]
    return [R(uid=uid0 + i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


def port_params(tree):
    """A params tree in the port's layout (the reference's converted from
    its stacked ``enc_layers`` / ``dec_layers``)."""
    if isinstance(tree["enc_layers"], dict):
        return convert.encdec_params_from_jax(
            jax.tree_util.tree_map(np.asarray, tree))
    return tree


def params_np(tree) -> list:
    return [t.numpy().copy() for t in tree_leaves(port_params(tree))]


def state_leaves(eng) -> dict:
    """keystr -> numpy array of an engine's decode state in the
    reference's layout (``self`` stacked, ``cross_k`` / ``cross_v``)."""
    if isinstance(eng, JEngine):
        flat = jax.tree_util.tree_flatten_with_path(eng.state)[0]
        return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}
    out = {}
    for path, leaf in _flatten(_stack_state(eng.model, eng.state)):
        if hasattr(leaf, "host_array"):
            leaf = leaf.host_array()
        out[path] = np.asarray(leaf)
    return out


def same_state(j, t):
    """The observable lifecycle state of two engines is equal."""
    assert t.scheduler.events == j.scheduler.events
    assert json.loads(json.dumps(t.scheduler.to_dict())) == \
        json.loads(json.dumps(j.scheduler.to_dict()))
    tj, tt = _thresholds(j), _thresholds(t)
    assert tj.keys() == tt.keys()
    for name in tj:
        np.testing.assert_array_equal(tt[name][0], tj[name][0])
        assert tt[name][1].keys() == tj[name][1].keys()
        for w in tj[name][1]:
            np.testing.assert_array_equal(tt[name][1][w], tj[name][1][w])
    assert t.last_invalidation == j.last_invalidation
    assert (t._weight_gen, t._weight_prog_age_s, t._refresh_ord,
            t._tile_gens, t._rejit_pending, t._maint_pending) == \
        (j._weight_gen, j._weight_prog_age_s, j._refresh_ord,
         j._tile_gens, j._rejit_pending, j._maint_pending)
    assert t.health() == j.health()
    assert _no_wall(t.obs.metrics.snapshot()) == \
        _no_wall(j.obs.metrics.snapshot())
    for a, b in zip(params_np(j.params), params_np(t.params)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("generation", [0, 3])
def test_aging_is_the_references(generation):
    """Both stacks aged per crossbar tile, bitwise the reference's
    ``age_params`` of its stacked tree: the stacked 1-D leaves too, while
    the final LayerNorms pass through."""
    jm, jp, tm, tp = models()
    want = port_params(jget_device(PRESET).age_params(
        jp, generation=generation))
    got = tget_device(PRESET).age_params(tp, stacked=STACKS,
                                         generation=generation)
    assert _stacked_keys(tm) == STACKS
    names = [p for p, _ in _leaf_paths(tp)]
    moved = set()
    for name, a, b, p in zip(names, tree_leaves(want), tree_leaves(got),
                             tree_leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=name)
        if not np.array_equal(b.numpy(), p.numpy()):
            moved.add(name)
    assert {"['embed']['table']", "['pos_dec']"} <= moved
    assert not {n for n in names if n.startswith(("['enc_norm']",
                                                   "['dec_norm']"))} & moved
    for stack in STACKS:
        for i in range(len(tp[stack])):
            attn = "['attn']" if stack == "enc_layers" else "['cross_attn']"
            for leaf in ("['norm1']['scale']", "['norm2']['bias']",
                         f"{attn}['wq']['b']", "['mlp']['wi']['w']"):
                assert f"['{stack}'][{i}]{leaf}" in moved


def served(side, **path):
    """An engine of ``side`` on the aged chip without a scheduler, run to
    its end on ``requests``: the engine and its streams."""
    eng = engine(side, policy=None, **path)
    reqs = requests(side)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return eng, [list(r.generated) for r in reqs]


@functools.lru_cache(maxsize=None)
def reference_served():
    """The reference's scan engine on the aged chip: its streams and
    params (one run for every path held to it)."""
    eng, streams = served("jax")
    return streams, params_np(eng.params)


@pytest.mark.parametrize("path", [
    {}, dict(prefill="bucketed", pack_prefill=True)], ids=["scan", "packed"])
def test_streams_on_an_aged_chip(path):
    """Served on the aged chip without a scheduler: the streams are the
    reference's (its scan engine), the served params its aged ones."""
    want, want_params = reference_served()
    t, st = served("torch", **path)
    assert st == want
    for a, b in zip(want_params, params_np(t.params)):
        np.testing.assert_array_equal(b, a)
    assert all(not x.any() for c in t.state["cross"] for x in c.values())


@pytest.mark.parametrize("mode", ["at_once", "drain"])
def test_lifecycle_matches_reference(mode):
    """Threshold-only re-calibration of the flat ramp and of every bank,
    the crossbars of both stacks re-aged from the pristine params, applied
    at once or after the wave drained: streams, events, thresholds,
    params, invalidations and counters bitwise the reference's."""
    kw = dict(drain_before_rejit=True) if mode == "drain" else {}
    out = {}
    for side in SIDES:
        eng = engine(side, **kw)
        reqs = requests(side)
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out[side] = (eng, [list(r.generated) for r in reqs])
    (j, sj), (t, st) = out["jax"], out["torch"]
    assert st == sj
    assert sum(e["recalibrated"] for e in t.scheduler.events) >= 2
    d_ff = t.model.cfg.d_ff
    assert {k for k in t.scheduler.ramps if "@" in k} == \
        {f"act@{d_ff}:{b}" for b in range(d_ff // BANK_COLS)}
    same_state(j, t)


def test_maintenance_window_serves_the_snapshot():
    """Fleet mode: the re-program waits for ``begin_drain`` while the
    engine keeps admitting.  Inside the window the host thresholds have
    moved ahead of the decode path's, and the streams and the caches (the
    cross K/V included) stay the reference's."""
    streams, engines, states, window = {}, {}, {}, []
    for side in SIDES:
        eng = engine(side, external_maintenance=True)
        reqs = requests(side, PROMPTS[:2])
        for r in reqs:
            eng.submit(r)
        late = requests(side, [PROMPTS[i] for i in (0, 2, 3, 1)], uid0=10)
        while not eng.maintenance_pending:
            eng.step()
        for i in range(8):                    # serve and admit in the window
            if i % 2 == 0 and late:
                reqs.append(late.pop(0))
                eng.submit(reqs[-1])
            eng.step()
            if side == "torch":
                window.append(eng._threshold_fp() != eng._served_fp())
        assert eng.maintenance_pending and not eng.draining
        states[side] = state_leaves(eng)
        eng.begin_drain()
        for r in late:
            reqs.append(r)
            eng.submit(r)
        eng.run_to_completion()
        streams[side] = [list(r.generated) for r in reqs]
        engines[side] = eng
    assert streams["torch"] == streams["jax"]
    assert any(window)          # the host ran ahead of the served chip
    assert states["torch"].keys() == states["jax"].keys()
    assert {"['cross_k']", "['cross_v']", "['self']['k']"} <= \
        set(states["torch"])
    for path, want in states["jax"].items():
        np.testing.assert_allclose(states["torch"][path], want, rtol=0,
                                   atol=CACHE_ATOL, err_msg=path)
    same_state(engines["jax"], engines["torch"])


def test_weight_refresh_is_chip_wide():
    """Forced refreshes behind an unbanked ramp and behind a bank of the
    gelu ramp: ``EncDecLM`` maps no activation to param leaves, so each is
    a whole-chip re-program (``weight_gen`` moves, no col-tile record) and
    every crossbar of both stacks, their stacked 1-D leaves and the
    top-level matrices is re-aged, bitwise the reference's."""
    assert not hasattr(EncDecLM, "act_param_leaves")
    policy = dict(age_per_step_s=1e5, check_every=4, inl_threshold_lsb=0.05,
                  weight_refresh_after_stalls=1)
    engines = {side: engine(side, policy=policy) for side in SIDES}
    t = engines["torch"]
    d_ff = t.model.cfg.d_ff
    names = [p for p, _ in _leaf_paths(t.params)]
    for gen, key in enumerate(["act", f"act@{d_ff}:1"], start=1):
        before = params_np(t.params)
        assert t._per_tile_refresh_scope([key]) is None
        for eng in engines.values():
            eng.scheduler.weight_refresh_pending = True
            eng.scheduler.weight_refresh_ramps = [key]
            eng._on_chip_reprogram()
        same_state(engines["jax"], t)
        assert t._weight_gen == gen and not t._tile_gens
        moved = {n for n, a, b in zip(names, before, params_np(t.params))
                 if not np.array_equal(a, b)}
        aged = {n for n, p in zip(names, tree_leaves(t.params))
                if p.ndim >= 2 or n.startswith(tuple(
                    f"['{s}']" for s in STACKS))}
        assert moved == aged


def test_weight_refresh_in_a_run_matches_reference():
    """Fast aging past what re-calibration fixes: the scheduler asks for
    chip-wide refreshes while requests are served; streams, generations
    and params are the reference's."""
    out = {}
    for side in SIDES:
        eng = engine(side, policy=dict(
            age_per_step_s=1e5, check_every=2, inl_threshold_lsb=0.05,
            weight_refresh_after_stalls=1))
        reqs = requests(side, PROMPTS[:2])
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out[side] = (eng, [list(r.generated) for r in reqs])
    (j, sj), (t, st) = out["jax"], out["torch"]
    assert st == sj and t._weight_gen >= 1 and not t._tile_gens
    same_state(j, t)
