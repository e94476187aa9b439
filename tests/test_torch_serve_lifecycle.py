"""The serving engine's lifecycle against the JAX package's engine.

repro_torch's ``ServingEngine(recal=, drain_before_rejit=,
external_maintenance=, obs=)`` and the JAX package's at SMOKE sizes,
float32, ``ref`` backend, ``aged-1day``, the same weights
(``lm_params_from_jax``): token streams, the scheduler's events and
state, the deployed and served thresholds, the re-aged and refreshed
params, ``last_invalidation``, the lifecycle counters and the metrics are
the reference's, bitwise, with the re-program applied at once, after a
drain, and through a maintenance window in which requests are admitted
(the reference's traces keep serving the chip they were compiled with
while the scheduler has moved the thresholds on the host).  Checkpoints
with a scheduler and an ``obs`` block are read both ways, and a resume is
the uninterrupted run.
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
from repro_torch.core.device import get_device as tget_device
from repro_torch.launch import serve as TSERVE
from repro_torch.nn.model import build as tbuild
from repro_torch.obs import strip_wall
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.lifecycle import RecalPolicy
from repro_torch.train.optim import tree_leaves

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

PRESET = "aged-1day"
PROMPTS = [np.arange(1, 6, dtype=np.int32), np.arange(2, 15, dtype=np.int32),
           np.asarray([7], np.int32), np.arange(3, 25, dtype=np.int32),
           np.arange(5, 9, dtype=np.int32), np.arange(11, 20, dtype=np.int32)]
POLICY = dict(age_per_step_s=3600.0, check_every=2, inl_threshold_lsb=0.4)
CACHE_ATOL = 1e-5        # two packages' float32 matmuls (seen: 9.5e-7)
SIDES = {"jax": (JEngine, JRequest, JPolicy, jget_device),
         "torch": (ServingEngine, Request, RecalPolicy, tget_device)}


@functools.lru_cache(maxsize=None)
def _models(bank_cols=0):
    """(jax model, jax params, port model, port params), built once."""
    jcfg = JC.get_smoke("qwen2.5-3b").replace(
        dtype="float32", analog=JSpec(enabled=True, mode="infer",
                                      device=PRESET, backend="ref",
                                      bank_cols=bank_cols))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = TSERVE.make_config(
        "qwen2.5-3b", smoke=True, backend="ref", analog_mode="infer",
        analog_device=PRESET, bank_cols=bank_cols).replace(dtype="float32")
    tm = tbuild(tcfg, device="cpu")
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def _engine(side, bank_cols=0, policy=POLICY, **kw):
    jm, jp, tm, tp = _models(bank_cols)
    E, _, P, get = SIDES[side]
    model, params = (jm, jp) if side == "jax" else (tm, tp)
    return E(model, params, max_batch=2, max_len=48, device=get(PRESET),
             recal=P(**policy), **kw)


def _requests(side, prompts=PROMPTS, max_new=6, uid0=0):
    R = SIDES[side][1]
    return [R(uid=uid0 + i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


def _params_np(eng):
    """The engine's params as numpy leaves of the port's layout."""
    p = eng.params
    if isinstance(p["layers"], dict):                # the reference's
        p = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, p))
    return [t.numpy().copy() for t in tree_leaves(p)]


def _thresholds(eng):
    """Every activation's deployed ramp and bank thresholds (float64)."""
    return {name: (np.asarray(act.ramp.thresholds),
                   {w: np.asarray(b.thresholds_f64)
                    for w, b in sorted(act.banks().items())})
            for name, act in sorted(eng._acts.items())}


def _no_wall(snap):
    """A metrics snapshot without its host-clock (``*_ms``) histograms."""
    return [m for m in snap["metrics"] if not m["name"].endswith("_ms")]


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


MODES = {"at_once": dict(), "drain": dict(drain_before_rejit=True),
         "packed": dict(prefill="bucketed", pack_prefill=True)}


@functools.lru_cache(maxsize=None)
def _lifecycle_run(side, mode):
    """(engine, streams) of one side's run of the requests in ``mode``,
    run once for every test that reads it."""
    eng = _engine(side, **MODES[mode])
    reqs = _requests(side)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return eng, [list(r.generated) for r in reqs]


@pytest.mark.parametrize("mode", list(MODES))
def test_lifecycle_matches_reference(mode):
    """Re-calibrations and re-aged crossbars, applied at once, after the
    wave drained, or on the packed bucketed path: streams, events,
    thresholds, params, invalidations and counters bitwise; the drain
    changes the streams (the re-program lands later)."""
    (j, sj), (t, st) = _lifecycle_run("jax", mode), \
        _lifecycle_run("torch", mode)
    assert st == sj
    assert sum(e["recalibrated"] for e in t.scheduler.events) >= 2
    _same_state(j, t)
    if mode == "drain":
        assert _lifecycle_run("torch", "at_once")[1] != st


@pytest.mark.parametrize("prefill", ["scan", "bucketed"])
def test_maintenance_window_with_admission(prefill):
    """Fleet mode: the re-program waits for ``begin_drain`` while the
    engine keeps admitting.  Inside the window the host thresholds have
    moved ahead of the decode path's, new prompt lengths (scan) or new
    buckets are programmed with the moved ones, and the streams stay the
    reference's."""
    kw = dict(external_maintenance=True, prefill=prefill)
    if prefill == "bucketed":
        kw["prefill_buckets"] = (4, 8, 16, 32)
    streams, engines, caches, window = {}, {}, {}, []
    for side in SIDES:
        eng = _engine(side, **kw)
        reqs = _requests(side, PROMPTS[:2])
        for r in reqs:
            eng.submit(r)
        # the first repeats a prompt length served before the window
        late = _requests(side, [PROMPTS[i] for i in (0, 2, 3, 1, 4, 5)],
                         uid0=10)
        steps = 0
        while not eng.maintenance_pending:
            eng.step()
            steps += 1
        for i in range(8):                    # serve and admit in the window
            if i % 2 == 0 and late:
                reqs.append(late.pop(0))
                eng.submit(reqs[-1])
            eng.step()
            if side == "torch":
                window.append(eng._threshold_fp() != eng._served_fp())
        assert eng.maintenance_pending and not eng.draining
        caches[side] = _caches(eng)
        eng.begin_drain()
        for r in late:
            reqs.append(r)
            eng.submit(r)
        eng.run_to_completion()
        streams[side] = [list(r.generated) for r in reqs]
        engines[side] = eng
    assert streams["torch"] == streams["jax"]
    assert any(window)          # the host ran ahead of the served chip
    # the window's prefills wrote the served chip's activations: the
    # caches agree to float32 rounding (a prefill on the host's moved
    # thresholds is off by ~0.5)
    for a, b in zip(caches["jax"], caches["torch"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=CACHE_ATOL)
    _same_state(engines["jax"], engines["torch"])


def _caches(eng):
    """The decode caches as (n_layers, ...) numpy arrays, K then V."""
    layers = eng.state["layers"]
    if isinstance(layers, dict):                     # the reference's
        return [np.asarray(layers[k]) for k in ("k", "v")]
    return [np.stack([layer[k].numpy() for layer in layers])
            for k in ("k", "v")]


def _bank_engine(side):
    """Banked (64 columns) SMOKE qwen with a refresh after one stall."""
    return _engine(side, bank_cols=64, policy=dict(
        age_per_step_s=1e5, check_every=4, inl_threshold_lsb=0.05,
        weight_refresh_after_stalls=1))


@pytest.mark.parametrize("scope", ["per_tile", "full"])
def test_weight_refresh_matches_reference(scope):
    """A stalled bank of the hidden activation re-programs only the
    col-tiles feeding it (a per-tile refresh); an unbanked stall
    re-programs the whole chip, and a later per-tile refresh salts with a
    higher ordinal: the params after each re-program are the reference's
    (only the mapped leaves' columns move under the per-tile one)."""
    engines = {side: _bank_engine(side) for side in SIDES}
    d_ff = _models(64)[2].cfg.d_ff
    before = _params_np(engines["torch"])
    keys = [f"act@{d_ff}:1"] if scope == "per_tile" \
        else ["sigmoid_act", f"act@{d_ff}:0"]
    for key in keys:
        for eng in engines.values():
            eng.scheduler.weight_refresh_pending = True
            eng.scheduler.weight_refresh_ramps = [key]
            eng._on_chip_reprogram()
        _same_state(engines["jax"], engines["torch"])
    t = engines["torch"]
    if scope == "per_tile":
        assert t._weight_gen == 0 and set(t._tile_gens) == set(keys)
        names = [path for path, _ in _leaf_paths(t.params)]
        moved = {n for n, a, b in zip(names, before, _params_np(t))
                 if not np.array_equal(a, b)}
        assert moved and all("['wi_gate']" in n or "['wi_up']" in n
                             for n in moved)
    else:
        assert t._weight_gen == 1 and t._tile_gens[keys[1]]["gen"] == 2


def _leaf_paths(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaf_paths(v, f"{path}[{i}]")]
    return [(path, tree)]


def test_weight_refresh_in_a_run_matches_reference():
    """Fast aging past what recal fixes: the scheduler asks for refreshes
    while requests are served; streams, generations and params are the
    reference's, and the refresh rides in the checkpoint."""
    out = {}
    for side in SIDES:
        eng = _engine(side, policy=dict(
            age_per_step_s=1e5, check_every=2, inl_threshold_lsb=0.05,
            weight_refresh_after_stalls=1))
        reqs = _requests(side, PROMPTS[:3], max_new=8)
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        out[side] = (eng, [list(r.generated) for r in reqs])
    (j, sj), (t, st) = out["jax"], out["torch"]
    assert st == sj and t._weight_gen >= 1
    _same_state(j, t)


def _window_run(side, save_at=None, root=None):
    """Drain-before-rejit, saved inside the drain window (or run through
    it): returns the engine and its requests."""
    eng = _engine(side, drain_before_rejit=True, noise_seed=7)
    reqs = _requests(side, PROMPTS[:4])
    for r in reqs:
        eng.submit(r)
    steps = 0
    while save_at is not None and not eng._rejit_pending:
        eng.step()
        steps += 1
    if save_at is not None:
        eng.save(root, steps)
    return eng, reqs


@pytest.mark.parametrize("way", ["torch_to_jax", "jax_to_torch"])
def test_checkpoint_read_both_ways(tmp_path, way):
    """Saved inside a drain window by one package, restored by the other,
    which finishes the wave on the served chip, re-programs at the drain
    point and continues with the uninterrupted run's streams."""
    writer, reader = way.split("_to_")
    full, reqs = _window_run(writer)
    full.run_to_completion()
    want = {r.uid: list(r.generated) for r in reqs}
    root = str(tmp_path / way)
    _window_run(writer, save_at=True, root=root)
    jm, jp, tm, tp = _models()
    if reader == "jax":
        res = JEngine.restore(jm, root, params_like=jp,
                              drain_before_rejit=True)
    else:
        res = ServingEngine.restore(tm, root, params_like=_clone(tp),
                                    drain_before_rejit=True)
    assert res._rejit_pending and res.scheduler is not None
    live = [r for r in list(res.slot_req) + res.queue if r is not None]
    res.run_to_completion()
    for r in live:
        assert list(r.generated) == want[r.uid], f"uid {r.uid}"
    assert res.scheduler.events == full.scheduler.events
    for a, b in zip(_params_np(full), _params_np(res)):
        np.testing.assert_array_equal(b, a)


def _clone(tree):
    """A params tree with its own tensors (a restore writes into it)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def test_resume_is_the_uninterrupted_run(tmp_path):
    """Saved inside a drain window and restored by the port: streams,
    params, thresholds, the scheduler's state, the metrics and the trace
    (wall fields stripped) are the uninterrupted run's."""
    full, reqs = _window_run("torch")
    full.run_to_completion()
    # the engines share the model's activations: read them before the
    # next engine re-programs them
    tf = _thresholds(full)
    root = str(tmp_path / "ck")
    part, part_reqs = _window_run("torch", save_at=True, root=root)
    _, _, tm, tp = _models()
    res = ServingEngine.restore(tm, root, params_like=_clone(tp),
                                drain_before_rejit=True)
    restored = {r.uid: r for r in list(res.slot_req) + res.queue
                if r is not None}
    res.run_to_completion()
    got = {r.uid: r.generated for r in part_reqs}
    got.update({uid: r.generated for uid, r in restored.items()})
    assert restored and got == {r.uid: r.generated for r in reqs}
    assert res.scheduler.to_dict() == full.scheduler.to_dict()
    assert _no_wall(res.obs.metrics.snapshot()) == \
        _no_wall(full.obs.metrics.snapshot())
    trace = strip_wall(part.obs.tracer.entries + res.obs.tracer.entries)
    assert trace == strip_wall(full.obs.tracer.entries)
    for a, b in zip(_params_np(full), _params_np(res)):
        np.testing.assert_array_equal(b, a)
    tr = _thresholds(res)
    for name in tf:
        np.testing.assert_array_equal(tr[name][0], tf[name][0])
    pristine = [t.numpy() for t in tree_leaves(res._pristine_params)]
    assert all(np.array_equal(a, b.numpy())
               for a, b in zip(pristine, tree_leaves(tp)))
