"""The fault-tolerant trainer: repro_torch's ``ft.executor`` and the
``Trainer`` around it against the JAX package's, with no model.

* The reference's four executor scenarios
  (``tests/test_train_ckpt_ft.py``: transient retries, restore and replay
  on a lost worker, the straggler deadline, the heartbeat monitor) run
  through both packages' classes; their outputs and ``ExecutorStats``
  must be equal.  Two more: the backoff's sleeps and the retry limit, and
  a lost worker without a ``restore_fn``.
* A ``Trainer`` over a trivial step (``w <- 2 w + step``, exact in
  float32) with ``ckpt_every=2``: a ``WorkerFailure`` injected at step 3
  rewinds to the step-2 checkpoint and replays, ending bitwise on the
  uninterrupted run; with ``log_every=2`` and ``start_step=1`` its
  ``executor.stats``, ``history`` (without the wall clock), ``Obs``
  metrics and trace equal the reference ``Trainer``'s on the same
  injection.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ft import executor as JEX
from repro.obs import Obs as JObs
from repro.train import loop as JLOOP
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.ft import executor as TEX
from repro_torch.obs import Obs as TObs
from repro_torch.train import loop as TLOOP

import _torch_threads  # noqa: E402,F401  (one intra-op thread)


def _retries(ex):
    calls = {"n": 0}

    def step_fn(state, step):
        calls["n"] += 1
        if calls["n"] < 3:
            raise ex.TransientFailure("flaky link")
        return state + 1

    run = ex.RetryingExecutor(step_fn, backoff_s=0.0)
    return run.run_step(0, 0), run.stats


def _restore(ex):
    events = []

    def step_fn(state, step):
        if step == 3 and not events:
            events.append("fail")
            raise ex.WorkerFailure("host lost")
        return state + 1

    run = ex.RetryingExecutor(step_fn, restore_fn=lambda step: (100, 2))
    state, step, trail = 0, 0, []
    while step < 5:
        state, step = run.run_step(state, step)
        trail.append((state, step))
    return trail, run.stats


def _straggler(ex):
    pol = ex.StragglerPolicy(multiplier=2.0, min_deadline_s=0.0)
    out = [pol.deadline()]
    for dt in [1.0] * 10 + [5.0, 1.0, 0.25, 3.5]:
        out.append((pol.observe(dt), pol.deadline()))
    return out, dataclasses.asdict(ex.StragglerPolicy())


def _heartbeat(ex):
    t = {"now": 0.0}
    mon = ex.HeartbeatMonitor(3, timeout_s=5.0, clock=lambda: t["now"])
    t["now"] = 3.0
    mon.beat(0)
    mon.beat(1)
    out = [mon.dead_workers(), mon.healthy()]
    t["now"] = 7.0
    out += [mon.dead_workers(), mon.healthy()]
    mon.beat(2)
    return out + [mon.dead_workers()]


def _backoff(ex):
    slept = []

    def always(state, step):
        raise ex.TransientFailure("down")

    run = ex.RetryingExecutor(always, max_retries=3, backoff_s=0.5,
                              sleep=slept.append)
    with pytest.raises(ex.TransientFailure):
        run.run_step(0, 0)
    return slept, run.stats


def _no_restore(ex):
    def lost(state, step):
        raise ex.WorkerFailure("host lost")

    run = ex.RetryingExecutor(lost)
    with pytest.raises(ex.WorkerFailure):
        run.run_step(0, 0)
    return run.stats


SCENARIOS = {"retries": _retries, "restore": _restore,
             "straggler": _straggler, "heartbeat": _heartbeat,
             "backoff": _backoff, "no_restore": _no_restore}


def _plain(x):
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_executor_scenario_matches_the_reference(name):
    got, want = (_plain(SCENARIOS[name](ex)) for ex in (TEX, JEX))
    assert got == want
    if name == "retries":
        assert got == [[1, 1], {"steps": 1, "retries": 2, "restores": 0,
                                "stragglers": 0}]
    if name == "restore":
        assert got[0][-1] == [103, 5] and got[1]["restores"] == 1


# -- the Trainer around the executor -----------------------------------------

# start_step 1: steps 1 and 2 run, 3 fails and rewinds to the step-2
# checkpoint, then 2 to 6 run: 8 calls of run_step, 7 steps done
N_STEPS, FAIL_AT, CALLS = 7, 3, 8


def _failing(step_fn, trainer, fail_at):
    """``step_fn`` raising one ``WorkerFailure`` at ``fail_at`` (before
    any update), after the checkpoint in flight is on disk."""
    failed = []

    def step(p, o, b, s):
        if int(s) == fail_at and not failed:
            failed.append(s)
            trainer.ckpt.wait()
            raise (TEX if isinstance(trainer, TLOOP.Trainer)
                   else JEX).WorkerFailure("host lost")
        return step_fn(p, o, b, s)

    return step


def _torch_step(p, o, b, s):
    p["w"].mul_(2.0).add_(float(s))
    o["m"].add_(1.0)
    return p, o, {"loss": p["w"].sum(), "grad_norm": o["m"].sum()}


def _jax_step(p, o, b, s):
    w = p["w"] * 2.0 + s
    m = o["m"] + 1.0
    return {"w": w}, {"m": m}, {"loss": jnp.sum(w), "grad_norm": jnp.sum(m)}


def _torch_run(root, fail_at=None, obs=None):
    tr = TLOOP.Trainer(None, None, _torch_step, SyntheticLM(16, 4, 2),
                       ckpt_dir=str(root), ckpt_every=2, log_every=2,
                       obs=obs, log=None)
    if fail_at is not None:
        tr.train_step = _failing(_torch_step, tr, fail_at)
    state = TLOOP.TrainState({"w": torch.arange(4, dtype=torch.float32)},
                             {"m": torch.zeros(2)})
    return tr, tr.fit(state, N_STEPS, start_step=1)


def _history(tr):
    return [{k: v for k, v in h.items() if k != "wall_s"}
            for h in tr.history]


def test_worker_failure_rewinds_and_replays_bitwise(tmp_path):
    full, want = _torch_run(tmp_path / "a")
    tr, got = _torch_run(tmp_path / "b", fail_at=FAIL_AT)
    assert dataclasses.asdict(tr.executor.stats) == {
        "steps": CALLS - 1, "retries": 0, "restores": 1, "stragglers": 0}
    assert dataclasses.asdict(full.executor.stats)["steps"] == N_STEPS - 1
    assert torch.equal(got.params["w"], want.params["w"])
    assert torch.equal(got.opt_state["m"], want.opt_state["m"])
    # the replay's steps are the uninterrupted run's; the restore logs step
    # 2 again (the reference's rule: step % log_every == 0)
    assert [h["step"] for h in tr.history] == [2, 2, 4, 6, 7]
    assert _history(full) == [h for i, h in enumerate(_history(tr))
                              if i != 1]
    assert len(tr.step_ms) == CALLS


def test_trainer_stats_history_and_obs_match_the_reference(tmp_path):
    tobs, jobs = TObs(trace=True), JObs(trace=True)
    tr, got = _torch_run(tmp_path / "t", fail_at=FAIL_AT, obs=tobs)
    jtr = JLOOP.Trainer(None, None, _jax_step, SyntheticLM(16, 4, 2),
                        ckpt_dir=str(tmp_path / "j"), ckpt_every=2,
                        log_every=2, obs=jobs)
    jtr.train_step = _failing(jtr.train_step, jtr, FAIL_AT)
    want = jtr.fit(JLOOP.TrainState(
        {"w": jnp.arange(4, dtype=jnp.float32)}, {"m": jnp.zeros(2)}),
        N_STEPS, start_step=1)
    np.testing.assert_array_equal(got.params["w"].numpy(),
                                  np.asarray(want.params["w"]))
    assert dataclasses.asdict(tr.executor.stats) \
        == dataclasses.asdict(jtr.executor.stats)
    assert _history(tr) == _history(jtr)
    hold_obs(tobs, jobs, CALLS)


def hold_obs(tobs, jobs, calls: int) -> None:
    """The trainers' ``Obs``: the same metrics, the counter's value, the
    gauges within rtol 1e-5, the step histogram's count (its values are
    wall clock), and the same trace (no wall fields: ``Obs``' default)."""
    snap_t, snap_j = (o.metrics.snapshot()["metrics"] for o in (tobs, jobs))
    assert [(m["name"], m["kind"]) for m in snap_t] \
        == [(m["name"], m["kind"]) for m in snap_j] == [
            ("train.grad_norm", "gauge"), ("train.loss", "gauge"),
            ("train.step_ms", "histogram"), ("train.steps_total", "counter")]
    for mt, mj in zip(snap_t, snap_j):
        if mt["kind"] == "histogram":
            assert mt["state"]["count"] == mj["state"]["count"] == calls
        else:
            np.testing.assert_allclose(mt["state"]["value"],
                                       mj["state"]["value"], rtol=1e-5,
                                       err_msg=mt["name"])
    assert snap_t[-1]["state"]["value"] == calls
    trace = tobs.tracer.to_jsonl()
    assert trace == jobs.tracer.to_jsonl()
    assert trace.count('"train_step"') == calls and "wall" not in trace
