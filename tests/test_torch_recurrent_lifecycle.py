"""The recurrent LM families' lifecycle against the JAX package's engine.

repro_torch's ``ServingEngine(recal=, drain_before_rejit=,
external_maintenance=)`` and the JAX package's for mamba2-370m (SSD
blocks in ``layers``) and recurrentgemma-9b (5 layers: one (rec, rec,
attn) group in ``groups`` and the 2-block ``tail``), at SMOKE widths,
float32, ``ref`` backend, ``aged-1day``, 32-column threshold banks (the
GeGLU's gelu banks at d_ff 128, the RG-LRU's ``W_g`` gelu and gate
sigmoid banks at 64, the SSD z gate's silu banks at 128), the same
weights (``lm_params_from_jax``): token streams, the scheduler's events
and state, the deployed and served thresholds, the re-aged and refreshed
params (the hybrid's groups and tail), ``last_invalidation`` and the
lifecycle counters are the reference's, bitwise, with the re-program
applied at once, after a drain, and through a maintenance window.  A
per-tile weight refresh of the hybrid moves only the gate/up crossbars
of its groups and tail; mamba2's refresh is chip-wide (no mapped
activation feeds its SSD blocks).

The reference realizes a width's threshold bank at its first use and,
inside ``jax.jit``, keeps a tracer there; both packages' banks are
realized before any trace, at the widths the blocks apply them to.
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
from repro_torch.ckpt.checkpoint import _flatten, stack_layers
from repro_torch.core.device import get_device as tget_device
from repro_torch.launch import serve as TSERVE
from repro_torch.nn.model import build as tbuild
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.lifecycle import RecalPolicy
from repro_torch.train.optim import tree_leaves
from test_torch_serve_lifecycle import _leaf_paths, _no_wall, _thresholds

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

ARCHS = ("mamba2-370m", "recurrentgemma-9b")
OVERRIDES = {"mamba2-370m": (), "recurrentgemma-9b": (("n_layers", 5),)}
PRESET = "aged-1day"
BANK_COLS = 32
PROMPTS = [np.arange(1, 6, dtype=np.int32), np.arange(2, 15, dtype=np.int32),
           np.asarray([7], np.int32), np.arange(3, 25, dtype=np.int32)]
POLICY = dict(age_per_step_s=3600.0, check_every=2, inl_threshold_lsb=0.4)
CACHE_ATOL = 1e-5        # two packages' float32 matmuls
SIDES = {"jax": (JEngine, JRequest, JPolicy, jget_device),
         "torch": (ServingEngine, Request, RecalPolicy, tget_device)}


def used_widths(cfg) -> tuple:
    """``(activation, width)`` of every NL-ADC call of a recurrent family's
    blocks: the hybrid's GeGLU gate (d_ff) and ``W_g`` branch (lru_width)
    on the hidden gelu, its RG-LRU gates on the sigmoid; SSD's z gate
    (d_inner) on the silu and its dt (one a head) on the softplus."""
    if cfg.family == "hybrid":
        return (("act", cfg.d_ff), ("act", cfg.lru_width),
                ("sigmoid_act", cfg.lru_width))
    d_inner = cfg.ssm_expand * cfg.d_model
    return (("silu_act", d_inner), ("softplus_act", d_inner // cfg.ssm_headdim))


def realize_banks(*models) -> None:
    """Realize the threshold banks of every used width, in one order, in
    each model (the reference's first use inside ``jax.jit`` would keep a
    tracer)."""
    for m in models:
        for name, width in used_widths(m.cfg):
            getattr(m, name).bank_for(width)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(jax model, jax params, port model, port params), built once."""
    kw = dict(OVERRIDES[arch])
    jcfg = JC.get_smoke(arch).replace(
        dtype="float32", analog=JSpec(enabled=True, mode="infer",
                                      device=PRESET, backend="ref",
                                      bank_cols=BANK_COLS), **kw)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = TSERVE.make_config(
        arch, smoke=True, backend="ref", analog_mode="infer",
        analog_device=PRESET, bank_cols=BANK_COLS,
        overrides=kw).replace(dtype="float32")
    tm = tbuild(tcfg, device="cpu")
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    realize_banks(jm, tm)
    return jm, jp, tm, tp


def _engine(arch, side, policy=POLICY, **kw):
    jm, jp, tm, tp = _models(arch)
    E, _, P, get = SIDES[side]
    model, params = (jm, jp) if side == "jax" else (tm, tp)
    return E(model, params, max_batch=2, max_len=48, device=get(PRESET),
             recal=P(**policy), **kw)


def _requests(side, prompts=PROMPTS, max_new=6, uid0=0):
    R = SIDES[side][1]
    return [R(uid=uid0 + i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


def _port_params(eng):
    """The engine's params in the port's layout (the reference's converted
    from its stacked ``layers`` / ``groups``)."""
    p = eng.params
    if isinstance(p.get("layers", p.get("groups")), dict):
        p = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    return p


def _params_np(eng):
    return [t.numpy().copy() for t in tree_leaves(_port_params(eng))]


def _same_state(j, t):
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
    for a, b in zip(_params_np(j), _params_np(t)):
        np.testing.assert_array_equal(b, a)


def state_leaves(model, state) -> dict:
    """keystr -> numpy array of a decode state in the reference's layout
    (the port's per-layer or per-group list stacked; the tail a list)."""
    if isinstance(state.get("layers", state.get("groups")), dict):
        flat = jax.tree_util.tree_flatten_with_path(state)[0]
        return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}
    key = "groups" if model.cfg.family == "hybrid" else "layers"
    tree = dict(state, **{key: stack_layers(state[key])})
    out = {}
    for path, leaf in _flatten(tree):
        if hasattr(leaf, "host_array"):
            leaf = leaf.host_array()
        out[path] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("mode", ["at_once", "drain"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lifecycle_matches_reference(arch, mode):
    """Re-calibrations of the flat ramps and of every bank, and the
    crossbars re-aged from the pristine params (the hybrid's groups and
    tail), applied at once or after the wave drained: streams, events,
    thresholds, params, invalidations and counters bitwise the
    reference's."""
    kw = dict(drain_before_rejit=True) if mode == "drain" else {}
    out = {}
    for side in SIDES:
        eng = _engine(arch, side, **kw)
        reqs = _requests(side)
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out[side] = (eng, [list(r.generated) for r in reqs])
    (j, sj), (t, st) = out["jax"], out["torch"]
    assert st == sj
    assert sum(e["recalibrated"] for e in t.scheduler.events) >= 2
    banked = {k for k in t.scheduler.ramps if "@" in k}
    want = {f"{name}@{w}:{b}" for name, w in used_widths(t.model.cfg)
            for b in range(w // BANK_COLS) if w > BANK_COLS}
    assert banked == want
    _same_state(j, t)


@pytest.mark.parametrize("arch", ARCHS)
def test_maintenance_window_serves_the_snapshot(arch):
    """Fleet mode: the re-program waits for ``begin_drain`` while the
    engine keeps admitting.  Inside the window the host thresholds have
    moved ahead of the decode path's, and the streams, the recurrent
    states and the (rolling) caches stay the reference's."""
    streams, engines, states, window = {}, {}, {}, []
    for side in SIDES:
        eng = _engine(arch, side, external_maintenance=True)
        reqs = _requests(side, PROMPTS[:2])
        for r in reqs:
            eng.submit(r)
        late = _requests(side, [PROMPTS[i] for i in (0, 2, 3, 1)], uid0=10)
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
        states[side] = state_leaves(eng.model, eng.state)
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
    for path, want in states["jax"].items():
        np.testing.assert_allclose(states["torch"][path], want, rtol=0,
                                   atol=CACHE_ATOL, err_msg=path)
    _same_state(engines["jax"], engines["torch"])


def _refresh_keys(arch, scope):
    """The ramps stalled for each forced refresh: a bank of the hidden
    activation (per tile), or an unbanked ramp then a bank (chip-wide,
    then per tile with a higher ordinal); mamba2's stalled ramps map to
    no param leaf, so both its refreshes are chip-wide."""
    cfg = _models(arch)[2].cfg
    if cfg.family == "ssm":
        return ["silu_act", f"silu_act@{cfg.ssm_expand * cfg.d_model}:1"]
    if scope == "per_tile":
        return [f"act@{cfg.d_ff}:1"]
    return ["sigmoid_act", f"act@{cfg.d_ff}:0"]


@pytest.mark.parametrize("arch,scope", [
    ("recurrentgemma-9b", "per_tile"), ("recurrentgemma-9b", "chip"),
    ("mamba2-370m", "chip")])
def test_weight_refresh_matches_reference(arch, scope):
    """Forced refreshes: the params after each re-program are the
    reference's in every group and tail leaf; under the hybrid's per-tile
    refresh only its groups' and tail's gate/up crossbars move."""
    policy = dict(age_per_step_s=1e5, check_every=4,
                  inl_threshold_lsb=0.05, weight_refresh_after_stalls=1)
    engines = {side: _engine(arch, side, policy=policy) for side in SIDES}
    before = _params_np(engines["torch"])
    keys = _refresh_keys(arch, scope)
    for key in keys:
        for eng in engines.values():
            eng.scheduler.weight_refresh_pending = True
            eng.scheduler.weight_refresh_ramps = [key]
            eng._on_chip_reprogram()
        _same_state(engines["jax"], engines["torch"])
    t = engines["torch"]
    names = [path for path, _ in _leaf_paths(t.params)]
    moved = {n for n, a, b in zip(names, before, _params_np(t))
             if not np.array_equal(a, b)}
    if scope == "per_tile":
        assert t._weight_gen == 0 and set(t._tile_gens) == set(keys)
        assert moved == {n for n in names
                         if "['wi_gate']" in n or "['wi_up']" in n}
        assert any(n.startswith("['groups']") for n in moved) and \
            any(n.startswith("['tail']") for n in moved)
    elif arch == "mamba2-370m":
        assert t._weight_gen == 2 and not t._tile_gens
        assert any("['ssd']" in n for n in moved)
    else:
        assert t._weight_gen == 1 and t._tile_gens[keys[1]]["gen"] == 2
        assert any(n.startswith("['tail']") and "['rec']" in n
                   for n in moved)


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_refresh_in_a_run_matches_reference(arch):
    """Fast aging past what recal fixes: the scheduler asks for refreshes
    while requests are served; streams, generations and params are the
    reference's."""
    out = {}
    for side in SIDES:
        eng = _engine(arch, side, policy=dict(
            age_per_step_s=1e5, check_every=2, inl_threshold_lsb=0.05,
            weight_refresh_after_stalls=1))
        reqs = _requests(side, PROMPTS[:2], max_new=6)
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out[side] = (eng, [list(r.generated) for r in reqs])
    (j, sj), (t, st) = out["jax"], out["torch"]
    assert st == sj and t._refresh_ord >= 1
    _same_state(j, t)
