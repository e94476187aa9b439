"""``repro_torch.serve.lifecycle`` and the rest of ``age_params`` against
the JAX package's.

The scheduler is host numpy over ``DeviceModel.tile_rng``, so it ports
bitwise: on qwen SMOKE's NL-ADC activations, flat and banked, under
``aged-1day``, ``stressed`` and ``paper-ir`` (whose banks sit at their
own wordline positions), the same ticks give the same events (INL values,
re-calibrated ramp keys, stalls, refresh requests), the same ``to_dict``
and the same deployed thresholds; a ``RampState`` programs, ages, probes
and re-calibrates to the reference's bits and round-trips through either
package's ``from_dict``.  ``age_params(stacked=, generation=,
leaf_overrides=, out=)`` gives the reference's stacked tree's values, and
its overrides see the reference's stacked paths and shapes.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.configs.base import AnalogSpec as JSpec
from repro.core.device import get_device as jget_device
from repro.core.nladc import build_ramp as jbuild_ramp
from repro.nn.model import build as jbuild
from repro.serve import lifecycle as JL
from repro_torch import convert
from repro_torch.core.device import get_device as tget_device
from repro_torch.core.nladc import build_ramp as tbuild_ramp
from repro_torch.launch import serve as TSERVE
from repro_torch.nn.model import build as tbuild
from repro_torch.serve import lifecycle as TL
from repro_torch.train.optim import tree_leaves

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

PRESETS = ("aged-1day", "stressed", "paper-ir")


@functools.lru_cache(maxsize=None)
def _models(preset, bank_cols):
    jcfg = JC.get_smoke("qwen2.5-3b").replace(
        dtype="float32", analog=JSpec(enabled=True, mode="infer",
                                      device=preset, backend="ref",
                                      bank_cols=bank_cols))
    tcfg = TSERVE.make_config(
        "qwen2.5-3b", smoke=True, backend="ref", analog_mode="infer",
        analog_device=preset, bank_cols=bank_cols).replace(dtype="float32")
    return jbuild(jcfg), tbuild(tcfg, device="cpu")


def _thresholds(acts):
    return {name: (np.asarray(a.ramp.thresholds),
                   {w: b.thresholds_f64 for w, b in sorted(a.banks().items())})
            for name, a in sorted(acts.items())}


def _equal_thresholds(a, b):
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(a[name][0], b[name][0])
        assert a[name][1].keys() == b[name][1].keys()
        for w in a[name][1]:
            np.testing.assert_array_equal(a[name][1][w], b[name][1][w])


@pytest.mark.parametrize("bank_cols", [0, 64], ids=["flat", "banked"])
@pytest.mark.parametrize("preset", PRESETS)
def test_scheduler_is_the_references(preset, bank_cols):
    jm, tm = _models(preset, bank_cols)
    jacts, tacts = JL.analog_activations(jm), TL.analog_activations(tm)
    assert list(tacts) == list(jacts)
    _equal_thresholds(_thresholds(tacts), _thresholds(jacts))
    policy = dict(age_per_step_s=2e4, check_every=2, inl_threshold_lsb=0.3,
                  weight_refresh_after_stalls=2)
    js = JL.RecalScheduler(jget_device(preset), jacts,
                           JL.RecalPolicy(**policy))
    ts = TL.RecalScheduler(tget_device(preset), tacts,
                           TL.RecalPolicy(**policy))
    for step in range(12):
        kw = {"age_per_step_s": 5e3} if step % 5 == 4 else {}
        assert ts.tick(**kw) == js.tick(**kw)
        if ts.weight_refresh_pending:
            assert ts.consume_weight_refresh() == \
                js.consume_weight_refresh()
    assert ts.events == js.events and ts.n_recals >= 1
    assert any(e["recalibrated"] for e in ts.events)
    assert json.dumps(ts.to_dict()) == json.dumps(js.to_dict())
    assert ts.probe_inl_per_ramp() == js.probe_inl_per_ramp()
    _equal_thresholds(_thresholds(tacts), _thresholds(jacts))
    if bank_cols:
        assert any("@" in k for k in ts.ramps)
    # either package's state restores into the other's scheduler
    back = TL.RecalScheduler.from_dict(
        json.loads(json.dumps(js.to_dict())), tacts)
    assert json.dumps(back.to_dict()) == json.dumps(js.to_dict())
    back.tick()
    js.tick()
    assert back.events == js.events


@pytest.mark.parametrize("preset", PRESETS)
def test_ramp_state_is_the_references(preset):
    jdev, tdev = jget_device(preset), tget_device(preset)
    for name, bits, frac in (("tanh", 5, 1.0), ("sigmoid", 4, 0.25),
                             ("silu", 5, 0.6)):
        j = JL.RampState.program(jdev, jbuild_ramp(name, bits), "k", frac)
        t = TL.RampState.program(tdev, tbuild_ramp(name, bits), "k", frac)
        assert json.dumps(t.to_dict()) == json.dumps(j.to_dict())
        for age in (0.0, 3600.0, 86400.0, 1e6):
            np.testing.assert_array_equal(t.conductances_at(tdev, age),
                                          j.conductances_at(jdev, age))
            np.testing.assert_array_equal(t.ramp_at(tdev, age).thresholds,
                                          j.ramp_at(jdev, age).thresholds)
            assert t.inl_at(tdev, age) == j.inl_at(jdev, age)
        for n in range(3):
            assert t.recalibrate(tdev, 1e5 * (n + 1), n) == \
                j.recalibrate(jdev, 1e5 * (n + 1), n)
        assert json.dumps(t.to_dict()) == json.dumps(j.to_dict())
        back = TL.RampState.from_dict(j.to_dict(), tbuild_ramp(name, bits))
        assert json.dumps(back.to_dict()) == json.dumps(j.to_dict())
        with pytest.raises(ValueError, match="was programmed for"):
            TL.RampState.from_dict(j.to_dict(), tbuild_ramp(name, 3))


@functools.lru_cache(maxsize=None)
def _params():
    jm, _ = _models("aged-1day", 0)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jp, tp


@pytest.mark.parametrize("generation", [0, 3])
def test_age_params_generation_and_overrides(generation):
    """The stacked aging with a generation salt and per-leaf col-tile
    overrides, into new tensors and in place (``out=``): the reference's
    values, its overrides called with the reference's paths and shapes."""
    jp, tp = _params()
    dev_j, dev_t = jget_device("aged-1day"), tget_device("aged-1day")
    calls = {"jax": [], "torch": []}

    def overrides(side):
        def fn(path, shape):
            calls[side].append((path, tuple(shape)))
            if "['mlp']['wi_gate']['w']" in path:
                return {0: (2, 5e4)}
            if "['attn']['wq']" in path:
                return {0: (0, 0.0)}
            return None
        return fn

    want = dev_j.age_params(jp, generation=generation,
                            leaf_overrides=overrides("jax"))
    got = dev_t.age_params(tp, stacked="layers", generation=generation,
                           leaf_overrides=overrides("torch"))
    assert sorted(set(calls["torch"])) == sorted(set(calls["jax"]))
    want_t = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, want))
    for a, b in zip(tree_leaves(got), tree_leaves(want_t)):
        assert torch.equal(a, b)
    out = {k: ([{kk: _clone(vv) for kk, vv in layer.items()}
                for layer in v] if k == "layers" else _clone(v))
           for k, v in tp.items()}
    res = dev_t.age_params(tp, stacked="layers", generation=generation,
                           leaf_overrides=overrides("torch"), out=out)
    assert res["embed"]["table"] is out["embed"]["table"]
    for a, b in zip(tree_leaves(res), tree_leaves(want_t)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="legacy sequential"):
        dev_t.age_params(tp, np.random.default_rng(0), generation=1)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()
