"""Fleets of the recurrent LM families against the JAX package's.

``repro_torch.serve.fleet.FleetEngine`` of mamba2-370m and of
recurrentgemma-9b (SMOKE widths; the hybrid at 5 layers: a group and its
2-block tail), float32, ``ref`` backend: 2 chips on ``aged-1day`` and a
``stressed`` canary under a recal storm (capacity floor 0.75,
least-loaded router) route, grant drain windows (never more than one
open), warn and stream as the reference fleet does, every chip's
scheduler with it; the port fleet's restart from a checkpoint saved
mid-maintenance (each chip's deployment checkpoint in the reference's
layout: the hybrid's groups stacked, its tail a list) is its own
uninterrupted run, as the reference's own restart is not (``ROADMAP.md``
queue C).
"""

import functools

import jax
import numpy as np
import pytest

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.nn.model import build as jbuild
from repro.serve import fleet as JF
from repro.serve.engine import Request as JRequest
from repro.serve.lifecycle import RecalPolicy as JPolicy
from repro_torch import convert
from repro_torch.launch import serve as TSERVE
from repro_torch.serve import fleet as TF
from repro_torch.serve.engine import Request
from repro_torch.serve.lifecycle import RecalPolicy

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

ARCHS = ("mamba2-370m", "recurrentgemma-9b")
OVERRIDES = {"mamba2-370m": (), "recurrentgemma-9b": (("n_layers", 5),)}
ANALOG = dict(enabled=True, mode="infer", device="aged-1day", backend="ref")
SIDES = {"jax": (JF, JRequest, JPolicy), "torch": (TF, Request, RecalPolicy)}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jax config, jax params, port config, port params), built once."""
    kw = dict(OVERRIDES[arch])
    jcfg = JC.get_smoke(arch).replace(dtype="float32",
                                      analog=JSpec(**ANALOG), **kw)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tcfg = TSERVE.make_config(arch, smoke=True, backend="ref", overrides=kw)
    tcfg = tcfg.replace(dtype="float32",
                        analog=tcfg.analog.__class__(**ANALOG))
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, tcfg, tp


def _fleet(arch, side, n=3, recal=dict(age_per_step_s=5e4, check_every=2,
                                      inl_threshold_lsb=0.05)):
    jcfg, jp, tcfg, tp = _setup(arch)
    F, _, P = SIDES[side]
    extra = {} if side == "jax" else {"torch_device": "cpu"}
    return F.FleetEngine.build(
        jcfg if side == "jax" else tcfg, n,
        policy=F.FleetPolicy(capacity_floor=0.75, router="least-loaded"),
        recal=P(**recal), max_batch=1, max_len=32,
        canary_presets=("stressed",),
        params=jp if side == "jax" else tp, **extra)


def _traffic(side, fleet, n_req, steps, seed=0):
    R = SIDES[side][1]
    rng = np.random.default_rng(seed)
    homes, stream = [], {}
    for it in range(steps):
        if it < n_req:
            homes.append(fleet.submit(R(
                uid=it, prompt=rng.integers(0, 256, 4).astype(np.int32),
                max_new_tokens=3)))
        for uid, tok in sorted(fleet.step().items()):
            stream.setdefault(uid, []).append(int(tok))
    return homes, stream


@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_matches_reference(arch):
    """The recal storm on 2 chips and a canary: routing, planner grants
    (never more than one window open), the canary's warning, every chip's
    scheduler events, streams, admission latencies and health are the
    reference's."""
    out = {}
    for side in SIDES:
        fleet = _fleet(arch, side)
        homes, stream = _traffic(side, fleet, 8, 20)
        fleet.run_to_completion()
        out[side] = (fleet, homes, stream)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_restart_is_the_uninterrupted_run(tmp_path, arch):
    """Saved mid-maintenance and restored into a fresh ``FleetEngine``:
    the joined streams, the fleet's events, every chip's scheduler events
    and the metrics are the uninterrupted port fleet's."""
    recal = dict(age_per_step_s=2e4, check_every=2, inl_threshold_lsb=0.3)

    def fresh():
        fleet = _fleet(arch, "torch", recal=recal)
        rng = np.random.default_rng(3)
        for uid in range(5):
            fleet.submit(Request(uid=uid, prompt=rng.integers(
                0, 256, 4).astype(np.int32), max_new_tokens=4))
        return fleet

    def run(fleet, n, stream):
        for _ in range(n):
            for uid, tok in sorted(fleet.step().items()):
                stream.setdefault(uid, []).append(int(tok))

    full, full_stream = fresh(), {}
    run(full, 10, full_stream)
    part, stream = fresh(), {}
    run(part, 3, stream)
    assert any(c.engine.maintenance_pending or c.engine.draining
               for c in part.chips.values())
    root = str(tmp_path / "fleet")
    part.save(root, part.step_count)
    res = TF.FleetEngine.restore(_setup(arch)[2], root, torch_device="cpu")
    run(res, 7, stream)
    assert stream == full_stream
    assert res.events == full.events and res.bus.events == full.bus.events
    assert {c: ch.engine.scheduler.events for c, ch in res.chips.items()} \
        == {c: ch.engine.scheduler.events for c, ch in full.chips.items()}
    assert _no_ms(res) == _no_ms(full)


def _no_ms(fleet):
    return [m for m in fleet.obs.metrics.snapshot()["metrics"]
            if not m["name"].endswith("_ms")]
