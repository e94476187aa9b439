"""whisper-base deployed: its checkpoint, its fleet and the launcher's
deployment flags against the JAX package's.

The models and engines of ``tests/test_torch_whisper_deploy.py`` (SMOKE,
float32, ``ref`` backend, ``aged-1day``, 32-column banks, a scheduler that
ages the chip every step and drains before each re-program):

* the port writes the reference's tree: ``enc_layers`` and ``dec_layers``
  stacked on a leading axis in the params and the pristine params, the
  decode state's ``self`` caches stacked and its cross K/V as ``cross_k``
  and ``cross_v`` of shape (n_dec, B, enc_len, Hkv, D); a checkpoint of
  either package restores in the other (the cross K/V read back in their
  layer order), which finishes the run as the writer's uninterrupted run
  does; the port's restore into the scan path or the packed prefill with
  the detokenize thread is the uninterrupted run bitwise;
* a fleet of 2 chips on ``aged-1day`` and a ``stressed`` canary (infer
  mode, capacity floor 0.75, least-loaded router) routes, drains, warns
  and streams as the reference fleet does, and its restart from a
  checkpoint saved mid-maintenance is its own uninterrupted run;
* ``python -m repro_torch.launch.serve --arch whisper-base`` runs the
  deployment flags on the CPU: ``--recal-every`` with a trace and
  metrics, ``--ckpt-dir`` then ``--resume``, ``--fleet --canary``.
"""

import copy
import functools
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.nn.model import build as jbuild
from repro.serve import fleet as JF
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.lifecycle import RecalPolicy as JPolicy
from repro_torch import convert
from repro_torch.launch import serve as TSERVE
from repro_torch.serve import fleet as TF
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.lifecycle import RecalPolicy
from repro_torch.train.optim import tree_leaves
from test_torch_serve_lifecycle import _clone, _thresholds
from test_torch_whisper_deploy import (ARCH, engine, models, params_np,
                                       requests, state_leaves)

CROSS = ("['state']['cross_k']", "['state']['cross_v']")


PATHS = {"scan": {}, "packed_detok": dict(prefill="bucketed",
                                          pack_prefill=True,
                                          detok_thread=True)}


def window_run(side, save_at=False, root=None, **path):
    """Drain-before-rejit on a prefill ``path``, saved inside the first
    drain window (or run through it): the engine and its requests."""
    eng = engine(side, drain_before_rejit=True, noise_seed=7, **path)
    reqs = requests(side)
    for r in reqs:
        eng.submit(r)
    steps = 0
    while save_at and not eng._rejit_pending:
        eng.step()
        steps += 1
        assert steps < 64, "no drain window"
    if save_at:
        eng.save(root, steps)
    return eng, reqs


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """``(side, path)`` -> the window run of ``side`` on ``path``, made once
    and shared by the checkpoint tests: the uninterrupted run's outcome
    (streams, events, scheduler, params; for the port its thresholds,
    decode state and energy model, read before the next engine
    re-programs the model's activations) and ``root``, a checkpoint saved
    inside the first drain window of the same run, with ``saved``, the
    streams at the save.  The reference's save is a pure read of its
    state, so one of its engines saves and runs on; the port's saving run
    is an engine of its own."""
    cache = {}

    def get(side, path="scan"):
        if (side, path) not in cache:
            root = str(tmp_path_factory.mktemp(f"{side}_{path}"))
            jax_side = side == "jax"
            full, reqs = window_run(side, save_at=jax_side, root=root,
                                    **PATHS[path])
            saved = {r.uid: list(r.generated) for r in reqs}
            full.run_to_completion()
            out = dict(want={r.uid: list(r.generated) for r in reqs},
                       events=copy.deepcopy(full.scheduler.events),
                       sched=_json(full.scheduler.to_dict()),
                       params=params_np(full.params))
            if side == "torch":
                out.update(thr=copy.deepcopy(_thresholds(full)),
                           state={p: a.copy() for p, a in
                                  state_leaves(full).items()},
                           variants=full.energy.model.variants)
            if not jax_side:
                _, part_reqs = window_run(side, save_at=True, root=root,
                                          **PATHS[path])
                saved = {r.uid: list(r.generated) for r in part_reqs}
            out.update(root=root, saved=saved)
            cache[(side, path)] = SimpleNamespace(**out)
        return cache[(side, path)]

    return get


def _json(tree):
    return json.loads(json.dumps(tree))


def step_dir(root):
    """The one checkpoint directory under ``root``."""
    (d,) = Path(root).glob("step_*")
    return d


def manifest(root):
    with open(step_dir(root) / "manifest.json") as f:
        return json.load(f)


def test_checkpoint_is_the_references(windows):
    """Both packages save at the same point of the same run: the same leaf
    paths and dtypes (both stacks stacked, the cross K/V as ``cross_k`` /
    ``cross_v``); every leaf but the decode state and the noise key bit
    for bit, the decode state within float32 rounding."""
    roots = {side: windows(side).root for side in ("jax", "torch")}
    assert step_dir(roots["jax"]).name == step_dir(roots["torch"]).name
    mj, mt = (manifest(roots[s]) for s in ("jax", "torch"))
    assert mt["paths"] == mj["paths"] and mt["dtypes"] == mj["dtypes"]
    cfg = models()[2].cfg
    for p in ("['params']['enc_layers']['mlp']['wi']['w']",
              "['pristine']['dec_layers']['norm_x']['scale']",
              "['state']['self']['k']", *CROSS):
        assert p in mt["paths"], p
    for i, p in enumerate(mt["paths"]):
        a = np.load(step_dir(roots["torch"]) / f"leaf_{i:05d}.npy")
        b = np.load(step_dir(roots["jax"]) / f"leaf_{i:05d}.npy")
        assert a.dtype == b.dtype and a.shape == b.shape, p
        if p in CROSS:
            assert a.shape == (cfg.n_dec_layers, 2, cfg.enc_len,
                               cfg.n_kv_heads, cfg.head_dim)
            assert not a.any()          # served on text: never encoded
        if p.startswith("['noise_key']"):
            continue
        if p.startswith("['state']"):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=p)
        else:
            assert np.array_equal(a, b), p


@pytest.mark.parametrize("way", ["torch_to_jax", "jax_to_torch"])
def test_checkpoint_read_both_ways(windows, way):
    """Saved inside a drain window by one package, restored by the other,
    which finishes the wave on the served chip, re-programs at the drain
    point and continues with the uninterrupted run's streams."""
    writer, reader = way.split("_to_")
    full = windows(writer)
    jm, jp, tm, tp = models()
    if reader == "jax":
        res = JEngine.restore(jm, full.root, params_like=jp,
                              drain_before_rejit=True)
    else:
        res = ServingEngine.restore(tm, full.root, params_like=_clone(tp),
                                    drain_before_rejit=True)
    assert res._rejit_pending and res.scheduler is not None
    live = [r for r in list(res.slot_req) + res.queue if r is not None]
    assert live
    res.run_to_completion()
    for r in live:
        assert list(r.generated) == full.want[r.uid], f"uid {r.uid}"
    assert res.scheduler.events == full.events
    for a, b in zip(full.params, params_np(res.params)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("way", ["torch_to_jax", "jax_to_torch"])
def test_cross_kv_layout_read_both_ways(tmp_path, way):
    """Seeded cross K/V (as ``start_decode`` would leave them) written by
    one package come back in the other in their layer and batch order."""
    writer, reader = way.split("_to_")
    cfg = models()[2].cfg
    rng = np.random.default_rng(11)
    shape = (cfg.n_dec_layers, 2, cfg.enc_len, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    eng = engine(writer, policy=None)
    if writer == "jax":
        eng.state = dict(eng.state, cross_k=jax.numpy.asarray(ck),
                         cross_v=jax.numpy.asarray(cv))
    else:
        for i, c in enumerate(eng.state["cross"]):
            c["k"].copy_(torch.from_numpy(ck[i]))
            c["v"].copy_(torch.from_numpy(cv[i]))
    root = str(tmp_path / way)
    eng.save(root, 0)
    jm, jp, tm, tp = models()
    if reader == "jax":
        res = JEngine.restore(jm, root, params_like=jp)
    else:
        res = ServingEngine.restore(tm, root, params_like=_clone(tp))
    got = state_leaves(res)
    np.testing.assert_array_equal(got["['cross_k']"], ck)
    np.testing.assert_array_equal(got["['cross_v']"], cv)
    for a, b in zip(params_np(eng.params), params_np(res.params)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_resume_is_the_uninterrupted_run(windows, path):
    """Served on the scan path or the packed prefill with the detokenize
    thread, saved inside a drain window, restored by the port into the
    same path: streams, the decode state (the cross K/V too), params,
    thresholds, the pristine params and the scheduler's state are the
    uninterrupted run's."""
    full = windows("torch", path)
    _, _, tm, tp = models()
    res = ServingEngine.restore(tm, full.root, params_like=_clone(tp),
                                drain_before_rejit=True, **PATHS[path])
    restored = {r.uid: r for r in list(res.slot_req) + res.queue
                if r is not None}
    res.run_to_completion()
    got = dict(full.saved)
    got.update({uid: r.generated for uid, r in restored.items()})
    assert restored and got == full.want
    assert _json(res.scheduler.to_dict()) == full.sched
    for a, b in zip(full.params, params_np(res.params)):
        np.testing.assert_array_equal(b, a)
    have = state_leaves(res)
    assert have.keys() == full.state.keys()
    for p, want in full.state.items():
        np.testing.assert_array_equal(have[p], want, err_msg=p)
    have_thr = _thresholds(res)
    for name, (ramp, banks) in full.thr.items():
        np.testing.assert_array_equal(have_thr[name][0], ramp)
        for w in banks:
            np.testing.assert_array_equal(have_thr[name][1][w], banks[w])
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(res._pristine_params), tree_leaves(tp)))
    assert res.energy.model.variants == full.variants


# -- the fleet ---------------------------------------------------------------

ANALOG = dict(enabled=True, mode="infer", device="aged-1day", backend="ref")
FLEET_SIDES = {"jax": (JF, JRequest, JPolicy),
               "torch": (TF, Request, RecalPolicy)}


@functools.lru_cache(maxsize=None)
def fleet_setup():
    """(jax config, jax params, port config, port params), built once."""
    jcfg = JC.get_smoke(ARCH).replace(dtype="float32",
                                      analog=JSpec(**ANALOG))
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tcfg = TSERVE.make_config(ARCH, smoke=True, backend="ref")
    tcfg = tcfg.replace(dtype="float32",
                        analog=tcfg.analog.__class__(**ANALOG))
    tp = convert.encdec_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, tcfg, tp


def fleet(side, n=3, recal=dict(age_per_step_s=5e4, check_every=2,
                                inl_threshold_lsb=0.05)):
    jcfg, jp, tcfg, tp = fleet_setup()
    F, _, P = FLEET_SIDES[side]
    extra = {} if side == "jax" else {"torch_device": "cpu"}
    return F.FleetEngine.build(
        jcfg if side == "jax" else tcfg, n,
        policy=F.FleetPolicy(capacity_floor=0.75, router="least-loaded"),
        recal=P(**recal), max_batch=1, max_len=32,
        canary_presets=("stressed",),
        params=jp if side == "jax" else tp, **extra)


def test_fleet_matches_reference():
    """The recal storm on 2 chips and a canary: routing, planner grants
    (never more than one window open), the canary's warning, every chip's
    scheduler events, streams, admission latencies, health and energy are
    the reference's."""
    out = {}
    for side in FLEET_SIDES:
        f = fleet(side)
        R = FLEET_SIDES[side][1]
        rng = np.random.default_rng(0)
        homes, stream = [], {}
        for it in range(12):
            if it < 6:
                homes.append(f.submit(R(
                    uid=it, prompt=rng.integers(0, 128, 4).astype(np.int32),
                    max_new_tokens=3)))
            for uid, tok in sorted(f.step().items()):
                stream.setdefault(uid, []).append(int(tok))
        f.run_to_completion()
        out[side] = (f, homes, stream)
    (j, jh, js), (t, th, ts) = out["jax"], out["torch"]
    assert th == jh and ts == js
    assert t.events == j.events and t.bus.events == j.bus.events
    assert {c: ch.engine.scheduler.events for c, ch in t.chips.items()} == \
        {c: ch.engine.scheduler.events for c, ch in j.chips.items()}
    assert t.admission_latency_steps() == j.admission_latency_steps()
    assert t.health() == j.health()
    assert t.energy_report() == j.energy_report()
    open_w = 0
    for ev in t.events:
        open_w += {"drain_start": 1, "reprogram_done": -1}.get(ev["type"], 0)
        assert 0 <= open_w <= t.planner.max_drain == 1
    assert "drain_start" in [e["type"] for e in t.events]
    warns = [e for e in t.events if e["type"] == "canary_warning"]
    assert len(warns) == 1 and warns[0]["chip"] == "chip02"
    assert set(warns[0]["tightened"]) == {"chip00", "chip01"}


def test_fleet_restart_is_the_uninterrupted_run(tmp_path):
    """Saved mid-maintenance and restored into a fresh ``FleetEngine``:
    the joined streams, the fleet's events, every chip's scheduler events
    and the metrics are the uninterrupted port fleet's."""
    recal = dict(age_per_step_s=2e4, check_every=2, inl_threshold_lsb=0.3)

    def fresh():
        f = fleet("torch", recal=recal)
        rng = np.random.default_rng(3)
        for uid in range(5):
            f.submit(Request(uid=uid, prompt=rng.integers(
                0, 128, 4).astype(np.int32), max_new_tokens=4))
        return f

    def run(f, n, stream):
        for _ in range(n):
            for uid, tok in sorted(f.step().items()):
                stream.setdefault(uid, []).append(int(tok))

    full, full_stream = fresh(), {}
    run(full, 10, full_stream)
    part, stream = fresh(), {}
    run(part, 3, stream)
    assert any(c.engine.maintenance_pending or c.engine.draining
               for c in part.chips.values())
    root = str(tmp_path / "fleet")
    part.save(root, part.step_count)
    res = TF.FleetEngine.restore(fleet_setup()[2], root, torch_device="cpu")
    run(res, 7, stream)
    assert stream == full_stream
    assert res.events == full.events and res.bus.events == full.bus.events
    assert {c: ch.engine.scheduler.events for c, ch in res.chips.items()} \
        == {c: ch.engine.scheduler.events for c, ch in full.chips.items()}
    no_ms = [[m for m in f.obs.metrics.snapshot()["metrics"]
              if not m["name"].endswith("_ms")] for f in (res, full)]
    assert no_ms[0] == no_ms[1]


# -- the launcher ------------------------------------------------------------

BASE = ["--arch", ARCH, "--smoke", "--device", "cpu", "--analog-mode",
        "infer", "--analog-device", "aged-1day", "--requests", "3",
        "--max-new", "4", "--max-len", "32"]


@pytest.mark.parametrize("what", ["recal", "resume", "fleet"])
def test_serve_launcher_deploys(tmp_path, what):
    """The deployment flags on the CPU: the lifecycle with its trace and
    metrics; a checkpoint resumed; a fleet with a canary, checkpointed."""
    if what == "recal":
        trace = tmp_path / "t.jsonl"
        out = TSERVE.main(BASE + [
            "--age-per-step-s", "50000", "--recal-every", "2",
            "--recal-inl-lsb", "0.05", "--drain-before-rejit",
            "--trace", str(trace), "--metrics-dir", str(tmp_path / "m")])
        assert out["aged"] == "aged-1day" and out["tokens"] == 12
        assert out["lifecycle"]["probes"] >= 1
        assert out["lifecycle"]["recals"] >= 1
        assert trace.stat().st_size > 0
        assert (tmp_path / "m" / "metrics.prom").exists()
    elif what == "resume":
        ck = str(tmp_path / "ck")
        first = TSERVE.main(BASE + ["--age-per-step-s", "3600",
                                    "--recal-every", "8", "--ckpt-dir", ck])
        out = TSERVE.main(BASE + ["--recal-every", "8", "--ckpt-dir", ck,
                                  "--resume"])
        assert first["ckpt"] and out["ckpt"] != first["ckpt"]
        assert out["tokens"] == 12
        assert out["lifecycle"]["age_s"] > first["lifecycle"]["age_s"]
    else:
        ck = str(tmp_path / "fleet")
        out = TSERVE.main(BASE + [
            "--age-per-step-s", "50000", "--recal-every", "2",
            "--recal-inl-lsb", "0.05", "--fleet", "3", "--canary",
            "stressed", "--max-batch", "1", "--requests", "4",
            "--ckpt-dir", ck])
        assert out["chips"] == 3 and out["tokens"] == 16
        assert out["ckpt"] and out["events"] >= 1
        res = TF.FleetEngine.restore(
            TSERVE.make_config(ARCH, smoke=True, backend="ref",
                               analog_mode="infer",
                               analog_device="aged-1day"),
            ck, torch_device="cpu")
        assert len(res.chips) == 3
