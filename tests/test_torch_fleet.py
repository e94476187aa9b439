"""``repro_torch.serve.fleet`` and ``ft.elastic.plan_request_rebalance``
against the JAX package's.

The per-chip device derivation, the maintenance planner, the request
rebalance and the three routers are the reference's decision for
decision.  A SMOKE fleet of 3 chips and a ``stressed`` canary under a
recal storm (capacity floor 0.75) routes, grants windows, warns and
streams as the reference fleet does, and so does shelf aging of idle
chips; the port fleet's restart from a checkpoint saved mid-maintenance
is its own uninterrupted run.
"""

import functools

import jax
import numpy as np
import pytest

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.core.device import get_device as jget_device
from repro.ft.elastic import plan_request_rebalance as jrebalance
from repro.nn.model import build as jbuild
from repro.serve import fleet as JF
from repro.serve.engine import Request as JRequest
from repro.serve.lifecycle import RecalPolicy as JPolicy
from repro_torch import convert
from repro_torch.ckpt.checkpoint import save_checkpoint
from repro_torch.core.device import get_device as tget_device
from repro_torch.ft.elastic import plan_request_rebalance as trebalance
from repro_torch.launch import serve as TSERVE
from repro_torch.serve import fleet as TF
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.lifecycle import RecalPolicy

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

SIDES = {"jax": (JF, JRequest, JPolicy), "torch": (TF, Request, RecalPolicy)}


def test_chip_device_is_the_references():
    for preset in ("aged-1day", "stressed", "paper-ir"):
        for cid in ("chip00", "chip03", "edge-7"):
            t = TF.chip_device(tget_device(preset), cid)
            j = JF.chip_device(jget_device(preset), cid)
            assert t.to_dict() == j.to_dict() and t.name == f"{preset}@{cid}"


@pytest.mark.parametrize("floor", [0.0, 0.5, 0.75, 1.0])
def test_planner_is_the_references(floor):
    rng = np.random.default_rng(int(floor * 100))
    t, j = TF.MaintenancePlanner(5, floor), JF.MaintenancePlanner(5, floor)
    assert t.max_drain == j.max_drain
    for _ in range(60):
        cid = f"chip{int(rng.integers(0, 5)):02d}"
        op = rng.integers(0, 3)
        if op == 0:
            assert t.request(cid) == j.request(cid)
        elif op == 1:
            assert t.grant_next() == j.grant_next()
        elif t.draining:
            done = t.draining[int(rng.integers(0, len(t.draining)))]
            t.complete(done)
            j.complete(done)
        assert len(t.draining) <= t.max_drain
        assert t.to_dict() == j.to_dict()
    assert TF.MaintenancePlanner.from_dict(j.to_dict()).to_dict() == \
        j.to_dict()


def test_plan_request_rebalance_is_the_references():
    rng = np.random.default_rng(0)
    for _ in range(20):
        loads = {f"c{i}": int(rng.integers(0, 5))
                 for i in range(int(rng.integers(1, 5)))}
        displaced = list(range(int(rng.integers(0, 9))))
        assert trebalance(displaced, loads) == jrebalance(displaced, loads)
    with pytest.raises(ValueError, match="no surviving chips"):
        trebalance([1], {})


def test_policy_validation_and_restore_hints(tmp_path):
    for bad, match in ((dict(router="random"), "unknown router"),
                       (dict(capacity_floor=1.5), "capacity_floor"),
                       (dict(shelf_age_per_step_s=-1.0),
                        "shelf_age_per_step_s")):
        with pytest.raises(ValueError, match=match):
            TF.FleetPolicy(**bad)
    assert TF.FleetPolicy().to_dict() == JF.FleetPolicy().to_dict()
    assert TF.ROUTERS == JF.ROUTERS
    save_checkpoint(str(tmp_path / "f"), 1, {},
                    metadata={"fleet": {"schema": 1}})
    with pytest.raises(ValueError, match="FleetEngine.restore"):
        ServingEngine.restore(None, str(tmp_path / "f"))
    save_checkpoint(str(tmp_path / "e"), 1, {},
                    metadata={"engine": {"max_batch": 1, "max_len": 8}})
    cfg = TSERVE.make_config("qwen2.5-3b", smoke=True, backend="ref")
    with pytest.raises(ValueError, match="ServingEngine.restore"):
        TF.FleetEngine.restore(cfg, str(tmp_path / "e"))


@functools.lru_cache(maxsize=None)
def _setup(mode="infer"):
    analog = dict(enabled=True, mode="infer", device="aged-1day",
                  backend="ref") if mode == "infer" else dict(enabled=False)
    jcfg = JC.get_smoke("qwen2.5-3b").replace(dtype="float32",
                                              analog=JSpec(**analog))
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tcfg = TSERVE.make_config("qwen2.5-3b", smoke=True, backend="ref")
    tcfg = tcfg.replace(dtype="float32", analog=tcfg.analog.__class__(
        **analog))
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, tcfg, tp


def _fleet(side, n=4, canaries=("stressed",), mode="infer", policy=None,
           recal=dict(age_per_step_s=5e4, check_every=2,
                      inl_threshold_lsb=0.05), **kw):
    jcfg, jp, tcfg, tp = _setup(mode)
    F, _, P = SIDES[side]
    extra = {} if side == "jax" else {"torch_device": "cpu"}
    return F.FleetEngine.build(
        jcfg if side == "jax" else tcfg, n,
        policy=F.FleetPolicy(**(policy or {})),
        recal=None if recal is None else P(**recal), max_batch=1,
        max_len=48, canary_presets=canaries,
        params=jp if side == "jax" else tp, **extra, **kw)


def _traffic(side, fleet, n_req, steps, uid0=0, seed=0, stream=None):
    R = SIDES[side][1]
    rng = np.random.default_rng(seed)
    homes, stream = [], {} if stream is None else stream
    for it in range(steps):
        if it < n_req:
            homes.append(fleet.submit(R(
                uid=uid0 + it,
                prompt=rng.integers(0, 256, 4).astype(np.int32),
                max_new_tokens=3)))
        for uid, tok in sorted(fleet.step().items()):
            stream.setdefault(uid, []).append(int(tok))
    return homes, stream


@pytest.mark.parametrize("router", ["round-robin", "least-loaded",
                                    "health-weighted"])
def test_fleet_matches_reference(router):
    """The recal storm on 3 chips and a canary: routing, planner grants
    (never more than one window open), the canary's warning, every chip's
    scheduler events, streams and admission latencies are the
    reference's."""
    out = {}
    for side in SIDES:
        fleet = _fleet(side, policy=dict(capacity_floor=0.75,
                                         router=router))
        homes, stream = _traffic(side, fleet, 12, 30)
        fleet.run_to_completion()
        out[side] = (fleet, homes, stream)
    (j, jh, js), (t, th, ts) = out["jax"], out["torch"]
    assert th == jh and ts == js
    assert t.events == j.events and t.bus.events == j.bus.events
    assert {c: ch.engine.scheduler.events for c, ch in t.chips.items()} == \
        {c: ch.engine.scheduler.events for c, ch in j.chips.items()}
    assert t.admission_latency_steps() == j.admission_latency_steps()
    assert t.health() == j.health()
    open_w = 0
    for ev in t.events:
        open_w += {"drain_start": 1, "reprogram_done": -1}.get(ev["type"], 0)
        assert 0 <= open_w <= t.planner.max_drain == 1
    warns = [e for e in t.events if e["type"] == "canary_warning"]
    assert len(warns) == 1 and warns[0]["chip"] == "chip03"
    assert set(warns[0]["tightened"]) == {"chip00", "chip01", "chip02"}
    assert len(t.admission_latency_steps()) == 12


def test_shelf_aging_wakes_idle_canary():
    """An idle canary drifts, probes and warns only with shelf aging, as
    in the reference fleet."""
    out = {}
    for side in SIDES:
        fleet = _fleet(side, n=3, policy=dict(router="round-robin"))
        for _ in range(4):
            fleet.step()
        assert fleet.events == []
        fleet.policy = SIDES[side][0].FleetPolicy(
            router="round-robin", shelf_age_per_step_s=5e4)
        for _ in range(10):
            fleet.step()
        out[side] = fleet
    t, j = out["torch"], out["jax"]
    assert t.events == j.events
    assert "canary_warning" in [e["type"] for e in t.events]
    assert t.health() == j.health()


def test_fleet_restart_is_the_uninterrupted_run(tmp_path):
    """Saved mid-maintenance and restored into a fresh ``FleetEngine``:
    the joined streams, the fleet's events and every chip's scheduler
    events are the uninterrupted port fleet's."""
    kw = dict(n=3, policy=dict(), recal=dict(
        age_per_step_s=2e4, check_every=2, inl_threshold_lsb=0.3))

    def fresh():
        fleet = _fleet("torch", **kw)
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
    run(full, 8, full_stream)
    part, stream = fresh(), {}
    run(part, 3, stream)
    assert any(c.engine.maintenance_pending or c.engine.draining
               for c in part.chips.values())
    root = str(tmp_path / "fleet")
    part.save(root, part.step_count)
    _, _, tcfg, _ = _setup()
    res = TF.FleetEngine.restore(tcfg, root, torch_device="cpu")
    run(res, 5, stream)
    assert stream == full_stream
    assert res.events == full.events and res.bus.events == full.bus.events
    assert {c: ch.engine.scheduler.events for c, ch in res.chips.items()} \
        == {c: ch.engine.scheduler.events for c, ch in full.chips.items()}
    assert res.obs.metrics.snapshot()["metrics"][0] == \
        full.obs.metrics.snapshot()["metrics"][0]
