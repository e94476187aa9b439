"""repro_torch's build-stage weight aging against the JAX package's,
bitwise: ``DeviceModel.age_weights`` (one rng), ``age_weights_tiled``
(per-crossbar streams keyed by ``crc32`` of the leaf path and the tile;
generations and per-col-tile re-programs) and ``age_params`` (tiled with
no rng, the deployment path; sequential with an explicit rng), for every
registered preset with a build stage.  Both packages compute in numpy
float64 from ``numpy.random.Generator`` streams, so every value is equal.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import crossbar as JCB
from repro.core import device as JD
from repro.nn import lstm as JL
from repro_torch import convert
from repro_torch.core import crossbar as TCB
from repro_torch.core import device as TD
from test_torch_lstm import SMOKE, _specs

import _torch_threads  # noqa: E402,F401  (one intra-op thread)

BUILD_PRESETS = tuple(n for n in sorted(JD.device_names())
                      if JD.get_device(n).has_build_stage)
# a partial-tile matrix under a small plan: row tiles 16, 16, 8;
# col tiles 24, 24, 22
SHAPE, TILE = (40, 70), (16, 24)


def _w(shape=SHAPE, seed=0):
    return np.random.default_rng(seed).normal(0, 0.7, shape)


def test_build_presets_cover_the_ir_presets():
    assert {"paper-infer", "aged-1day", "stressed", "paper-ir",
            "stressed-ir"} <= set(BUILD_PRESETS)
    assert not TD.get_device("paper").has_build_stage


@pytest.mark.parametrize("preset", BUILD_PRESETS)
def test_age_weights_bitwise(preset):
    jd, td = JD.get_device(preset), TD.get_device(preset)
    a = jd.age_weights(_w(), np.random.default_rng(1))
    b = td.age_weights(_w(), np.random.default_rng(1))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(b, _w())


@pytest.mark.parametrize("generation", (0, 2))
@pytest.mark.parametrize("preset", BUILD_PRESETS)
def test_age_weights_tiled_bitwise(preset, generation):
    jd, td = JD.get_device(preset), TD.get_device(preset)
    jplan, tplan = JCB.plan_tiles(*SHAPE, *TILE), TCB.plan_tiles(*SHAPE,
                                                                 *TILE)
    w = np.stack([_w(seed=2), _w(seed=3)])          # two stacked matrices
    a = jd.age_weights_tiled(w, "['lstm']['w_gates']", jplan, generation)
    b = td.age_weights_tiled(w, "['lstm']['w_gates']", tplan, generation)
    np.testing.assert_array_equal(a, b)
    # a re-program of col-tile 1 (its own generation and drift clock)
    ov = {1: (generation + 1, 3_600.0)}
    a = jd.age_weights_tiled(w, "k", jplan, generation, col_overrides=ov)
    b = td.age_weights_tiled(w, "k", tplan, generation, col_overrides=ov)
    np.testing.assert_array_equal(a, b)
    plain = td.age_weights_tiled(w, "k", tplan, generation)
    assert np.array_equal(b[..., :24], plain[..., :24])
    assert not np.array_equal(b[..., 24:48], plain[..., 24:48])


@pytest.mark.parametrize("preset", ("paper-ir", "stressed-ir"))
def test_age_weights_tiled_default_plan(preset):
    """The paper's 633x512 tiling of a PTB-shaped (but shortened) gate
    matrix: one row tile, 2 full col tiles and a partial one."""
    w = _w((64, 1100), seed=4)
    np.testing.assert_array_equal(
        JD.get_device(preset).age_weights_tiled(w, "['fc']['w']"),
        TD.get_device(preset).age_weights_tiled(w, "['fc']['w']"))


def _trees(seed=0):
    js, _ = _specs("infer")
    pj = JL.classifier_init(jax.random.PRNGKey(seed), js, SMOKE.n_classes)
    pj = jax.tree_util.tree_map(np.asarray, pj)
    pj["fc"]["b"] = np.arange(SMOKE.n_classes, dtype=np.float32)
    pt = convert.params_from_jax(pj)
    pt["fc"]["b"] = torch.from_numpy(pj["fc"]["b"])
    return pj, pt


def _assert_trees_equal(tj, tt):
    assert sorted(tj) == sorted(tt)
    for k in tj:
        if isinstance(tj[k], dict):
            _assert_trees_equal(tj[k], tt[k])
        else:
            assert tt[k].dtype == torch.float32
            np.testing.assert_array_equal(tt[k].numpy(), np.asarray(tj[k]))


@pytest.mark.parametrize("preset", BUILD_PRESETS)
def test_age_params_tiled_bitwise(preset):
    pj, pt = _trees()
    aged_j = JD.get_device(preset).age_params(pj)
    aged_t = TD.get_device(preset).age_params(pt)
    _assert_trees_equal(aged_j, aged_t)
    # vectors pass through untouched, as the same object
    assert aged_t["fc"]["b"] is pt["fc"]["b"]
    assert not torch.equal(aged_t["lstm"]["w_gates"], pt["lstm"]["w_gates"])


@pytest.mark.parametrize("preset", BUILD_PRESETS)
def test_age_params_explicit_rng_bitwise(preset):
    pj, pt = _trees(1)
    _assert_trees_equal(
        JD.get_device(preset).age_params(pj, np.random.default_rng(5)),
        TD.get_device(preset).age_params(pt, np.random.default_rng(5)))


def test_age_params_tile_keys_are_keystr():
    """Each matrix leaf is aged tile by tile under the key
    ``jax.tree_util.keystr`` gives its path."""
    pj, pt = _trees()
    flat, _ = jax.tree_util.tree_flatten_with_path(pj)
    keys = [jax.tree_util.keystr(path) for path, leaf in flat
            if leaf.ndim >= 2]
    assert keys == ["['fc']['w']", "['lstm']['w_gates']",
                    "['lstm']['w_proj']"]
    dev = TD.get_device("paper-ir")
    aged = dev.age_params(pt)
    for key in keys:
        outer, inner = key[2:-2].split("']['")
        want = dev.age_weights_tiled(pt[outer][inner].double().numpy(), key)
        np.testing.assert_array_equal(aged[outer][inner].numpy(),
                                      want.astype(np.float32))
    # a list in the tree is spelled [i], as keystr spells a sequence
    tree = {"layers": [torch.ones(3, 4), torch.ones(3, 4)]}
    want = [jax.tree_util.keystr(path) for path, _ in
            jax.tree_util.tree_flatten_with_path(
                {"layers": [np.ones((3, 4))] * 2})[0]]
    assert want == ["['layers'][0]", "['layers'][1]"]
    aged = dev.age_params(tree)["layers"]
    for leaf, key in zip(aged, want):
        np.testing.assert_array_equal(
            leaf.numpy(),
            dev.age_weights_tiled(np.ones((3, 4)), key).astype(np.float32))
    assert not torch.equal(aged[0], aged[1])


def test_age_params_keeps_the_device_and_dtype():
    _, pt = _trees()
    pt["lstm"]["w_proj"] = pt["lstm"]["w_proj"].double()
    aged = TD.get_device("paper-ir").age_params(pt)
    assert aged["lstm"]["w_proj"].dtype == torch.float64
    assert aged["lstm"]["w_gates"].device == pt["lstm"]["w_gates"].device
    # no build stage: the tree itself
    assert TD.get_device("paper").age_params(pt) is pt


def test_plan_must_cover_the_matrix():
    plan = TCB.plan_tiles(32, 70, *TILE)
    with pytest.raises(ValueError, match="plan covers"):
        TD.get_device("paper-ir").age_weights_tiled(_w(), "k", plan)


@pytest.mark.parametrize("preset", sorted(TD.device_names()))
def test_lstm_eval_runs_every_preset_on_aged_weights(preset):
    """``lstm_eval --age-weights tiled`` on the CPU at KWS width: every
    registered preset builds and evaluates, on the tree ``age_params``
    gives."""
    from repro_torch.launch import lstm_eval

    out = lstm_eval.main(["--config", "kws_lstm", "--device", "cpu",
                          "--batches", "1", "--batch", "4",
                          "--analog-device", preset,
                          "--age-weights", "tiled"])
    assert out["analog_device"] == preset and np.isfinite(out["nll"])
    model = lstm_eval.build_model("kws_lstm", torch.device("cpu"),
                                  analog_device=preset,
                                  age_weights="tiled")
    fresh = lstm_eval.build_model("kws_lstm", torch.device("cpu"),
                                  analog_device=preset)
    aged = TD.get_device(preset).age_params(fresh.params())
    for got, want in ((model.w_gates, aged["lstm"]["w_gates"]),
                      (model.fc_w, aged["fc"]["w"])):
        assert torch.equal(got.detach(), want.detach())
    with pytest.raises(ValueError, match="age_weights"):
        lstm_eval.build_model("kws_lstm", torch.device("cpu"),
                              age_weights="sequential")


@pytest.mark.parametrize("t_s", [86400.0, 60.0, 0.0, 1e7])
@pytest.mark.parametrize("noise", [True, False])
def test_drift_weights_is_the_pairs_drift(t_s, noise):
    """``DriftModel.drift_weights`` interpolates once a weight (the pair's
    empty device drifts to the lowest reference curve): bit for bit
    ``drift(G+) - drift(G-)`` over the pair, the positive device's draws
    first, at and beside the reference levels, at 0 and -0, past the clip,
    at the smallest subnormal and at NaN."""
    model = TCB.DriftModel()
    levels = model.ref_levels() / TCB.GAMMA_US
    w = np.concatenate([
        np.random.default_rng(0).normal(0.0, 0.8, 20_000), levels, -levels,
        np.nextafter(levels, np.inf), [0.0, -0.0, 2.0, -2.0, 3.0, -3.0,
                                       5e-324, -5e-324, np.nan]])

    def rng():
        return np.random.default_rng(3) if noise else None

    g_pos, g_neg = TCB.weights_to_conductance_pairs(w)
    r = rng()       # one stream, the positive device's draws first
    want = TCB.conductance_pairs_to_weights(model.drift(g_pos, t_s, r),
                                            model.drift(g_neg, t_s, r))
    got = model.drift_weights(w, t_s, rng())
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
