"""The recurrent LM families' deployment checkpoint against the JAX
package's.

recurrentgemma-9b at SMOKE widths with 5 layers (one (rec, rec, attn)
group and the 2-block tail; window 8) and mamba2-370m, float32, ``ref``
backend, ``aged-1day``, 32-column banks, a re-calibration scheduler that
ages the chip every step and drains before each re-program.  The port
writes the reference's tree: the hybrid's groups stacked on a leading
axis (params, pristine params and the decode state: the RG-LRU ``h`` and
``conv`` states and the rolling KV slots), its tail a list.  Saved inside
a drain window once the rolling cache has wrapped (the shared index past
the window), a checkpoint of either package restores in the other and
finishes the run as the writer's uninterrupted run does; the port's
restore into the scan path or the packed prefill with the detokenize
thread is the uninterrupted run bitwise: streams, the decode state (the
rolled slots too), params, thresholds and the scheduler.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve.engine import ServingEngine as JEngine
from repro_torch.serve.engine import ServingEngine
from repro_torch.train.optim import tree_leaves
from test_torch_serve_lifecycle import _clone
from test_torch_recurrent_lifecycle import (ARCHS, _engine,
                                            _models, _params_np,
                                            _requests, _thresholds,
                                            state_leaves)

HYBRID = "recurrentgemma-9b"


def _window_run(arch, side, save_at=False, root=None, **path):
    """Drain-before-rejit on a prefill ``path``, saved inside the first
    drain window after the rolling cache wrapped (or run through it): the
    engine and its requests."""
    eng = _engine(arch, side, drain_before_rejit=True, noise_seed=7, **path)
    reqs = _requests(side)
    for r in reqs:
        eng.submit(r)
    window = _models(arch)[2].cfg.window
    steps = 0
    while save_at and not (eng._rejit_pending
                           and int(eng.state["index"]) > window):
        eng.step()
        steps += 1
        assert steps < 64, "no drain window after the cache wrapped"
    if save_at:
        eng.save(root, steps)
    return eng, reqs


def _step_dir(root):
    """The one checkpoint directory under ``root``."""
    (d,) = Path(root).glob("step_*")
    return d


def _manifest(root):
    with open(_step_dir(root) / "manifest.json") as f:
        return json.load(f)


def test_hybrid_checkpoint_is_the_references(tmp_path):
    """Both packages save at the same point of the same run: the same leaf
    paths and dtypes (groups stacked, ``['state']['groups']['b2_attn']``
    holding ``window`` slots, the tail by index); every leaf but the decode
    state and the noise key bit for bit, the decode state within float32
    rounding."""
    roots = {side: str(tmp_path / side) for side in ("jax", "torch")}
    for side, root in roots.items():
        _window_run(HYBRID, side, save_at=True, root=root)
    assert _step_dir(roots["jax"]).name == _step_dir(roots["torch"]).name
    mj, mt = (_manifest(roots[s]) for s in ("jax", "torch"))
    assert mt["paths"] == mj["paths"] and mt["dtypes"] == mj["dtypes"]
    window = _models(HYBRID)[2].cfg.window
    assert "['state']['groups']['b2_attn']['k']" in mt["paths"]
    assert "['params']['tail'][1]['mlp']['wi_gate']['w']" in mt["paths"]
    assert "['pristine']['groups']['b0_rec']['rec']['lam']" in mt["paths"]
    for i, p in enumerate(mt["paths"]):
        a = np.load(_step_dir(roots["torch"]) / f"leaf_{i:05d}.npy")
        b = np.load(_step_dir(roots["jax"]) / f"leaf_{i:05d}.npy")
        assert a.dtype == b.dtype and a.shape == b.shape, p
        if p == "['state']['groups']['b2_attn']['k']":
            assert a.shape[2] == window          # (n_groups, B, slots, ...)
        if p.startswith("['noise_key']"):
            continue
        if p.startswith("['state']"):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=p)
        else:
            assert np.array_equal(a, b), p


@pytest.mark.parametrize("way", ["torch_to_jax", "jax_to_torch"])
def test_hybrid_checkpoint_read_both_ways(tmp_path, way):
    """Saved inside a drain window by one package, restored by the other,
    which finishes the wave on the served chip, re-programs at the drain
    point and continues with the uninterrupted run's streams."""
    writer, reader = way.split("_to_")
    full, reqs = _window_run(HYBRID, writer)
    full.run_to_completion()
    want = {r.uid: list(r.generated) for r in reqs}
    root = str(tmp_path / way)
    _window_run(HYBRID, writer, save_at=True, root=root)
    jm, jp, tm, tp = _models(HYBRID)
    if reader == "jax":
        res = JEngine.restore(jm, root, params_like=jp,
                              drain_before_rejit=True)
    else:
        res = ServingEngine.restore(tm, root, params_like=_clone(tp),
                                    drain_before_rejit=True)
    assert res._rejit_pending and res.scheduler is not None
    live = [r for r in list(res.slot_req) + res.queue if r is not None]
    assert live
    res.run_to_completion()
    for r in live:
        assert list(r.generated) == want[r.uid], f"uid {r.uid}"
    assert res.scheduler.events == full.scheduler.events
    for a, b in zip(_params_np(full), _params_np(res)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("path", [
    {}, dict(prefill="bucketed", pack_prefill=True, detok_thread=True)],
    ids=["scan", "packed_detok"])
@pytest.mark.parametrize("arch", ARCHS)
def test_resume_is_the_uninterrupted_run(tmp_path, arch, path):
    """Served on the scan path or the packed prefill with the detokenize
    thread, saved inside a drain window after the cache wrapped, and
    restored by the port into the same path: streams, the decode state
    (the rolled slots and the recurrent states), params, thresholds, the
    pristine params and the scheduler's state are the uninterrupted
    run's."""
    full, reqs = _window_run(arch, "torch", **path)
    full.run_to_completion()
    # the engines share the model's activations: read them before the
    # next engine re-programs them
    want_thr = _thresholds(full)
    want_state = state_leaves(full.model, full.state)
    root = str(tmp_path / "ck")
    part, part_reqs = _window_run(arch, "torch", save_at=True, root=root,
                                  **path)
    got = {r.uid: r.generated for r in part_reqs}
    _, _, tm, tp = _models(arch)
    res = ServingEngine.restore(tm, root, params_like=_clone(tp),
                                drain_before_rejit=True, **path)
    restored = {r.uid: r for r in list(res.slot_req) + res.queue
                if r is not None}
    res.run_to_completion()
    got.update({uid: r.generated for uid, r in restored.items()})
    assert restored and got == {r.uid: r.generated for r in reqs}
    assert res.scheduler.to_dict() == full.scheduler.to_dict()
    for a, b in zip(_params_np(full), _params_np(res)):
        np.testing.assert_array_equal(b, a)
    have = state_leaves(res.model, res.state)
    assert have.keys() == want_state.keys()
    for p, want in want_state.items():
        np.testing.assert_array_equal(have[p], want, err_msg=p)
    have_thr = _thresholds(res)
    for name, (ramp, banks) in want_thr.items():
        np.testing.assert_array_equal(have_thr[name][0], ramp)
        for w in banks:
            np.testing.assert_array_equal(have_thr[name][1][w], banks[w])
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(res._pristine_params), tree_leaves(tp)))
